"""Image resampling with PyTorch ``F.interpolate`` semantics.

Counterpart of ``depthg_tpu/ops/resize.py``, which encodes each 1-D resample
as a dense weight matrix because that is what a TPU's matrix unit wants and
copies ``F.interpolate``'s semantics to do so. Here ``F.interpolate`` is the
semantics itself, so the resizes call it directly; only
``resized_sq_norm`` (which has no ``F.interpolate`` form) keeps the
interpolation matrices.

* bilinear align_corners=False — probe/logit upsampling;
* bilinear align_corners=True — kept for parity with the JAX signature;
* bicubic with an explicit ``scale`` — DINO's positional-embedding quirk;
* ``resize_bilinear_array`` — numpy in, numpy out (depth metrics, readers);
* ``adaptive_avg_pool2d`` — the depth map at feature resolution (FPS).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _size2(size):
    return (size, size) if isinstance(size, int) else tuple(size)


def _as4d(x: torch.Tensor):
    """[..., H, W] -> ([N, C, H, W] view, leading shape)."""
    lead = x.shape[:-2]
    if x.dim() == 4:
        return x, lead
    return x.reshape(1, -1, *x.shape[-2:]), lead


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False,
                    fast: bool = False) -> torch.Tensor:
    """``F.interpolate(x, size, mode="bilinear")`` for [..., H, W].

    Default: computed in float32 and cast back to the input dtype.
    ``fast=True`` stays in the input dtype (bf16 mean-field state in the
    CRF, whose values live in [0, 1] and are re-softmaxed every iteration).
    """
    oh, ow = _size2(size)
    h, w = x.shape[-2:]
    if (h, w) == (oh, ow):
        return x
    dtype = x.dtype
    x4, lead = _as4d(x if fast else x.float())
    y = F.interpolate(x4, size=(oh, ow), mode="bilinear",
                      align_corners=align_corners)
    return y.reshape(*lead, oh, ow).to(dtype)


def resize_bilinear_array(x, size, align_corners: bool = False) -> np.ndarray:
    """``resize_bilinear`` of a numpy array on the CPU, returned as numpy (the
    resize of the depth metrics and the eval readers, numpy-only modules)."""
    return resize_bilinear(torch.from_numpy(np.asarray(x)), size, align_corners).numpy()


def resize_bicubic(x: torch.Tensor, size, scale: tuple | None = None) -> torch.Tensor:
    """torch bicubic resize (align_corners=False), computed in float32.

    ``scale`` is the explicit ``scale_factor`` pair: the source index then
    uses 1/scale rather than in/out (DINO's ``interpolate_pos_encoding``
    passes ``(h0/side, w0/side)`` with a +0.1 fudge), which is exactly
    ``F.interpolate(scale_factor=...)``'s behaviour. The output size is
    ``size``; with ``scale`` given it must equal floor(in * scale)."""
    oh, ow = _size2(size)
    dtype = x.dtype
    x4, lead = _as4d(x.float())
    if scale is None:
        y = F.interpolate(x4, size=(oh, ow), mode="bicubic", align_corners=False)
    else:
        y = F.interpolate(x4, scale_factor=tuple(float(s) for s in scale),
                          mode="bicubic", align_corners=False)
        if tuple(y.shape[-2:]) != (oh, ow):
            raise ValueError(f"scale {scale} gives {tuple(y.shape[-2:])}, "
                             f"expected {(oh, ow)}")
    return y.reshape(*lead, oh, ow).to(dtype)


def _src_taps(in_size: int, out_size: int, align_corners: bool):
    """(i0, i1, w1) per output row of torch's linear interpolation."""
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            src = max((i + 0.5) * in_size / out_size - 0.5, 0.0)
        i0 = min(int(np.floor(src)), in_size - 1)
        yield i, i0, min(i0 + 1, in_size - 1), src - i0


@functools.lru_cache(maxsize=None)
def _linear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """[out, in] row-stochastic matrix of torch bilinear interpolation."""
    mat = np.zeros((out_size, in_size), np.float32)
    for i, i0, i1, w1 in _src_taps(in_size, out_size, align_corners):
        mat[i, i0] += 1.0 - w1
        mat[i, i1] += w1
    return mat


@functools.lru_cache(maxsize=None)
def _quad_linear_matrices(in_size: int, out_size: int, align_corners: bool):
    """[out, in] (A2, AB) with resize(y)_u^2 = (A2 @ y^2)_u + (AB @ g1)_u,
    g1_j = y_j * y_{min(j+1, in-1)} (see ``resized_sq_norm``)."""
    a2 = np.zeros((out_size, in_size), np.float32)
    ab = np.zeros((out_size, in_size), np.float32)
    for i, i0, i1, w1 in _src_taps(in_size, out_size, align_corners):
        a, b = 1.0 - w1, w1
        a2[i, i0] += a * a
        a2[i, i1] += b * b
        ab[i, i0] += 2.0 * a * b
    return a2, ab


def resized_sq_norm(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """Channel-summed squares of a bilinear resize, without materializing it.

    x: [B, C, H, W] -> [B, OH, OW], equal in exact arithmetic to
    ``(resize_bilinear(x, size) ** 2).sum(1)``. The W axis is resized
    exactly; the H-axis square expands through the 2-tap bilinear rows, so
    the [B, C, OH, OW] resized tensor never exists (float32 throughout)."""
    oh, ow = _size2(size)
    h, w = x.shape[-2:]
    x = x.float()
    if (h, w) == (oh, ow):
        return (x * x).sum(1)
    dev = x.device
    lw = torch.from_numpy(_linear_matrix(w, ow, align_corners)).to(dev)
    y = torch.einsum("bchw,vw->bchv", x, lw)
    y_next = torch.cat([y[:, :, 1:], y[:, :, -1:]], dim=2)
    g0 = (y * y).sum(1)
    g1 = (y * y_next).sum(1)
    a2, ab = (torch.from_numpy(m).to(dev)
              for m in _quad_linear_matrices(h, oh, align_corners))
    s = torch.einsum("uh,bhv->buv", a2, g0) + torch.einsum("uh,bhv->buv", ab, g1)
    return s.clamp_min(0.0)  # rounding can leave tiny negatives


def adaptive_avg_pool2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``F.adaptive_avg_pool2d`` for [..., H, W]."""
    oh, ow = _size2(out_hw)
    if tuple(x.shape[-2:]) == (oh, ow):
        return x
    x4, lead = _as4d(x)
    return F.adaptive_avg_pool2d(x4, (oh, ow)).reshape(*lead, oh, ow)


def adaptive_max_pool2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``F.adaptive_max_pool2d`` for [..., H, W] (values only)."""
    oh, ow = _size2(out_hw)
    x4, lead = _as4d(x)
    return F.adaptive_max_pool2d(x4, (oh, ow)).reshape(*lead, oh, ow)
