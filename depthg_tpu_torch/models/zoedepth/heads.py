"""ZoeDepth metric-bins head (``depthg_tpu/models/zoedepth/heads.py``): seed
bins, attractor refinement, conditional log-binomial.

Module names follow the released file (``seed_bin_regressor._net.{0,2}``,
``projectors.i._net``, ``attractors.i._net``, ``conditional_log_binomial.mlp``).
Both reference quirks the JAX package keeps are kept: the attractors use
alpha=300, gamma=2 whatever the configuration says, and the normed
attractor takes the un-normalized channel 0. The JAX package's dtype
promotions hold too: the log-binomial's k grid is float32, so under a bf16
model the probabilities (and the metric depth) come out in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from depthg_tpu_torch.models.zoedepth.layers import conv2d
from depthg_tpu_torch.ops.resize import resize_bilinear


def _mlp2(in_ch: int, mid: int, out_ch: int, act: nn.Module) -> nn.Sequential:
    """(1x1 conv, act, 1x1 conv): parameters at the released indices 0 and 2."""
    return nn.Sequential(conv2d(in_ch, mid, 1), act, conv2d(mid, out_ch, 1))


class SeedBinRegressor(nn.Module):
    def __init__(self, in_ch: int, n_bins: int, mid: int = 256):
        super().__init__()
        self._net = _mlp2(in_ch, mid, n_bins, nn.ReLU())

    def forward(self, x, kind="softplus", min_depth=1e-3, max_depth=10.0):
        """(widths or centers, centers) as ``seed_bin_regressor_softplus`` /
        ``_normed``."""
        if kind == "softplus":
            centers = F.softplus(self._net(x))
            return centers, centers
        b = F.relu(self._net(x)) + 1e-3
        widths_normed = b / b.sum(dim=1, keepdim=True)
        widths = F.pad((max_depth - min_depth) * widths_normed, (0, 0, 0, 0, 1, 0),
                       value=min_depth)
        edges = torch.cumsum(widths, dim=1)
        return widths_normed, 0.5 * (edges[:, :-1] + edges[:, 1:])


class Projector(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, mid: int = 128):
        super().__init__()
        self._net = _mlp2(in_ch, mid, out_ch, nn.ReLU())

    def forward(self, x):
        return self._net(x)


def inv_attractor(dx, alpha=300.0, gamma=2):
    return dx / (1 + alpha * dx ** gamma)


def exp_attractor(dx, alpha=300.0, gamma=2):
    return torch.exp(-alpha * dx.abs() ** gamma) * dx


class Attractor(nn.Module):
    """AttractorLayerUnnormed (softplus) / AttractorLayer (normed) forward."""

    def __init__(self, in_ch: int, out_ch: int, mid: int = 128):
        super().__init__()
        self._net = _mlp2(in_ch, mid, out_ch, nn.ReLU())

    def forward(self, x, b_prev, prev_b_embedding, *, kind, attractor_type, normed,
                min_depth=1e-3, max_depth=10.0):
        """Returns (b_new, bin centers)."""
        if prev_b_embedding is not None:
            x = x + resize_bilinear(prev_b_embedding, x.shape[-2:], align_corners=True)
        if normed:
            a = F.relu(self._net(x)) + 1e-3
            n, c, h, w = a.shape
            a = a.reshape(n, c // 2, 2, h, w)[:, :, 0]  # sic: the normalization is discarded
        else:
            a = F.softplus(self._net(x))
        b_centers = resize_bilinear(b_prev, a.shape[-2:], align_corners=True)
        dist = exp_attractor if attractor_type == "exp" else inv_attractor
        delta = dist(a[:, :, None] - b_centers[:, None])  # [B, n_attr, n_bins, H, W]
        delta = delta.mean(dim=1) if kind == "mean" else delta.sum(dim=1)
        b_new = b_centers + delta
        if not normed:
            return b_new, b_new
        centers = (max_depth - min_depth) * b_new + min_depth
        centers = torch.sort(centers, dim=1).values.clamp(min_depth, max_depth)
        return b_new, centers


def log_binomial(probs, t, n_classes, eps=1e-4):
    """LogBinomial forward: softmax over k of log C(K-1, k) + k log p +
    (K-1-k) log(1-p), divided by the temperature."""
    k = torch.arange(n_classes, dtype=torch.float32, device=probs.device).reshape(1, -1, 1, 1)
    big_k = float(n_classes - 1)
    x = probs.clamp(eps, 1.0)
    one_minus = (1.0 - probs).clamp(eps, 1.0)

    def log_binom(n, r, leps=1e-7):
        # the reference's log nCk uses its own eps=1e-7; the log argument is
        # clamped from below as in the JAX package (r <= n: no change)
        n = n + leps
        r = r + leps
        return n * torch.log(n) - r * torch.log(r) - (n - r) * torch.log(
            torch.clamp_min(n - r + leps, leps))

    y = log_binom(torch.full_like(k, big_k), k) + k * torch.log(x) \
        + (big_k - k) * torch.log(one_minus)
    return torch.softmax(y / t, dim=1)


class ConditionalLogBinomial(nn.Module):
    def __init__(self, in_ch: int, cond_ch: int, n_classes: int, bottleneck: int,
                 min_temp: float, max_temp: float):
        super().__init__()
        self.n_classes, self.min_temp, self.max_temp = n_classes, min_temp, max_temp
        self.mlp = nn.Sequential(conv2d(in_ch + cond_ch, bottleneck, 1), nn.GELU(),
                                 conv2d(bottleneck, 4, 1), nn.Softplus())

    def forward(self, x, cond, p_eps=1e-4):
        pt = self.mlp(torch.cat([x, cond], dim=1))
        prob, temp = pt[:, :2] + p_eps, pt[:, 2:] + p_eps
        prob = prob[:, 0] / (prob[:, 0] + prob[:, 1])
        temp = temp[:, 0] / (temp[:, 0] + temp[:, 1])
        temp = (self.max_temp - self.min_temp) * temp[:, None] + self.min_temp
        return log_binomial(prob[:, None], temp, self.n_classes)
