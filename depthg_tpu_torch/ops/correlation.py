"""Feature-correlation primitives of the STEGO/DepthG loss
(``depthg_tpu/ops/correlation.py``).

``tensor_correlation`` is all-pairs inner products between two sampled
feature grids: one batched [B, S*S, C] x [B, C, S*S] product in float32
(TF32 stays off, ``runtime.configure_numerics``); the 5-D view is a reshape.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def norm(t: torch.Tensor, dim: int = 1, eps: float = 1e-10) -> torch.Tensor:
    """``F.normalize(t, dim=dim, eps=1e-10)``, with the norm taken in f32."""
    return F.normalize(t.float(), dim=dim, eps=eps).to(t.dtype)


def tensor_correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum("nchw,ncij->nhwij"): a [B, C, H, W], b [B, C, I, J] ->
    [B, H, W, I, J], accumulated in float32."""
    bsz, c, h, w = a.shape
    i, j = b.shape[2:]
    out = torch.bmm(a.reshape(bsz, c, h * w).transpose(1, 2).float(),
                    b.reshape(bsz, c, i * j).float())
    return out.reshape(bsz, h, w, i, j).to(a.dtype)


def depth_correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same contraction for depth maps (C = 1), reference
    ``src/modules.py:812-814``."""
    return tensor_correlation(a, b)


def average_norm(t: torch.Tensor) -> torch.Tensor:
    """Divide by the mean channel norm instead of per-position norms."""
    return t / t.square().sum(1, keepdim=True).sqrt().mean()


def shuffle(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Rows of ``x`` in a random order drawn from ``generator``."""
    return x[torch.randperm(x.shape[0], generator=generator, device=x.device)]


def one_hot_feats(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """[B, H, W] int -> [B, C, H, W] float one-hot; labels outside
    [0, n_classes) give an all-zero column."""
    classes = torch.arange(n_classes, device=labels.device).view(1, -1, 1, 1)
    return (labels[:, None] == classes).float()
