"""Local Hidden Positive (LHP) projection (``depthg_tpu/models/lhp.py``).

The reference's ``LocalHiddenPositiveProjection`` and its "original"
variant: a per-patch affinity over the feature grid from either (a) the
distances of the depth map's point cloud or (b) the last block's mean
attention, thresholded to local neighbours, mixes the code; a
conv-relu-conv head (``proj.fc1``, ``proj.fc2``) projects the mix. The
head is frozen: it keeps the weights drawn from the caller's generator and
enters no optimizer, as in the reference.

Numerics held to the JAX package:

* the distances use the |a|^2 + |b|^2 - 2ab expansion of the JAX package
  (and of ``torch.cdist`` above 25 rows) as a float32 product; TF32 must be
  off on CUDA, or the cross term would move distances by ~0.1% and flip
  affinities near the threshold, so the function refuses to run with it on;
* the per-row thresholds are ``quantile``, ``jnp.quantile``'s formula
  low * (1 - w) + high * w after a sort, rounded as XLA computes it (one
  FMA): ``torch.quantile`` interpolates with ``lerp``, which rounds
  differently (by an ulp, also where the two order statistics tie), and
  older torch releases refuse its input above 2^24 elements
  ([32, 784, 784] at 224 px).

Reference quirks kept: the "original" variants divide by an all-zero tensor
and give +-inf; without depth (or, for the "attn" strategy, without
attention maps) ``lhp_apply`` is the projection alone.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from depthg_tpu_torch.models.layers import conv1x1
from depthg_tpu_torch.ops.depth import _depth2points
from depthg_tpu_torch.ops.resize import adaptive_avg_pool2d


@dataclasses.dataclass(frozen=True)
class LHPConfig:
    dim: int = 70
    res: int = 224
    patch_size: int = 8
    propagation_strategy: str = "depth"  # "depth" | "attn"
    original: bool = False

    @property
    def grid(self) -> int:
        return self.res // self.patch_size


@functools.lru_cache(maxsize=None)
def neighborhood_mask(sz: int) -> np.ndarray:
    """[sz*sz, sz*sz] 3x3-neighborhood adjacency (incl. self), matching the
    reference's hand-rolled index_set construction (``src/modules.py:159-183``)."""
    mask = np.zeros((sz * sz, sz * sz), np.float32)
    for r in range(sz):
        for c in range(sz):
            i = r * sz + c
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    rr, cc = r + dr, c + dc
                    if 0 <= rr < sz and 0 <= cc < sz:
                        mask[i, rr * sz + cc] = 1.0
    return mask


class LHP(nn.Module):
    """The projection head ``proj.fc1`` -> ReLU -> ``proj.fc2`` (1x1 convs)."""

    def __init__(self, cfg: LHPConfig):
        super().__init__()
        self.cfg = cfg
        self.proj = nn.Module()
        self.proj.fc1 = conv1x1(cfg.dim, cfg.dim)
        self.proj.fc2 = conv1x1(cfg.dim, cfg.dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LHP":
        """torch's default 1x1-conv distribution, uniform(+-1/sqrt(dim)),
        drawn from ``generator``."""
        bound = self.cfg.dim ** -0.5
        for p in self.parameters():
            p.uniform_(-bound, bound, generator=generator)
        return self

    def project(self, mixed: torch.Tensor) -> torch.Tensor:
        return self.proj.fc2(torch.relu(self.proj.fc1(mixed)))


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=-1, keepdims=True)`` (linear interpolation,
    float32 positions and weights, NaN for a row that holds one)."""
    n = x.shape[-1]
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = np.float32(pos - np.float32(lo))
    w_lo = np.float32(1.0) - w_hi
    s = x.sort(dim=-1).values
    # low * w_lo + high * w_hi with the first product unrounded: XLA fuses
    # it into one FMA (emulated in float64: both products are exact there)
    out = (s[..., lo:lo + 1].double() * float(w_lo)
           + (s[..., hi:hi + 1] * float(w_hi)).double()).to(x.dtype)
    return torch.where(x.isnan().any(dim=-1, keepdim=True), float("nan"), out)


def _pairwise_dists(points: torch.Tensor) -> torch.Tensor:
    """points [B, P, D] -> [B, P, P] euclidean distances (float32 product)."""
    if points.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("LHP distances need float32 products: TF32 is on "
                           "(depthg_tpu_torch.runtime.configure_numerics turns it off)")
    points = points.float()
    sq = (points * points).sum(dim=-1)
    cross = torch.bmm(points, points.transpose(1, 2))
    d2 = (sq[:, :, None] + sq[:, None, :] - 2 * cross).clamp_min(0.0)
    return d2.sqrt()


def _depth_normed(depth: torch.Tensor, hw: tuple, original: bool):
    """[B, 1, H, W] depth -> the point cloud's [B, P, P] distances scaled to
    [0, 1] per row, and each row's threshold [B, P, 1]."""
    d = adaptive_avg_pool2d(depth, hw)[:, 0]
    clouds = _depth2points(d, fov=90.0, far=5.0).permute(0, 2, 3, 1).reshape(d.shape[0], -1, 3)
    dist = _pairwise_dists(clouds)
    lo = dist.amin(dim=2, keepdim=True)
    hi = dist.amax(dim=2, keepdim=True)
    normed = (dist - lo) / (hi - lo)
    if original:
        return normed, normed.mean(dim=2, keepdim=True)
    return normed, quantile(normed, 0.01)


def _depth_affinity(depth: torch.Tensor, hw: tuple, original: bool) -> torch.Tensor:
    """[B, 1, H, W] depth -> [B, P, P] thresholded local affinity map."""
    normed, thresh = _depth_normed(depth, hw, original)
    return torch.where(normed > thresh, 0.0, 1.0 - normed)


def _attn_affinity(attn: torch.Tensor, original: bool) -> torch.Tensor:
    """[B, h, N+1, N+1] attention -> [B, P, P] affinity."""
    a = attn[:, :, 1:, 1:].mean(dim=1).float()
    if original:
        hi = quantile(a, 0.9)
        lo = quantile(a, 0.1)
        a = (a - lo) / (hi - lo)
        a = torch.where(a < a.mean(dim=2, keepdim=True), 0.0, a)
    else:
        lo = a.amin(dim=2, keepdim=True)
        hi = a.amax(dim=2, keepdim=True)
        a = (a - lo) / (hi - lo)
        cap = quantile(a, 0.99)
        a = torch.where(a > cap, 0.0, a)
    return a


def lhp_apply(lhp: LHP, code: torch.Tensor, depth: torch.Tensor | None = None,
              attn: torch.Tensor | None = None) -> torch.Tensor:
    """code [B, C, H, W] -> projected code (the reference's ``forward``).

    Without depth: the projection alone. The "attn" strategy also needs
    ``attn``, while the "depth" strategy never reads it, so it propagates
    when the backbone ran through the attention kernel (no maps)."""
    cfg = lhp.cfg
    if depth is None or (cfg.propagation_strategy == "attn" and attn is None):
        return lhp.project(code)

    b, c, h, w = code.shape
    code_flat = code.reshape(b, c, h * w).transpose(1, 2)  # [B, P, C]

    if cfg.propagation_strategy == "depth":
        aff = _depth_affinity(depth, (h, w), cfg.original)
    elif cfg.propagation_strategy == "attn":
        aff = _attn_affinity(attn, cfg.original)
    else:
        raise ValueError(f"Unknown propagation strategy: {cfg.propagation_strategy}")

    if cfg.original:
        aff = aff * torch.from_numpy(neighborhood_mask(h)).to(aff.device)[None]
        mixed = torch.bmm(aff, code_flat.float())
        # the reference divides by an all-zeros divide_num: +-inf, kept
        mixed = mixed / torch.zeros((h * w, 1), dtype=mixed.dtype, device=mixed.device)
    else:
        mixed = torch.bmm(aff, code_flat.float()) / torch.full(
            (), h * w, dtype=torch.float32, device=code.device)

    mixed = mixed.transpose(1, 2).reshape(b, c, h, w).to(code.dtype)
    return lhp.project(mixed)
