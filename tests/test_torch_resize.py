"""Resampling of the PyTorch port vs the JAX package (``ops/resize.py``).

Both compute torch ``F.interpolate`` semantics in float32 (the JAX package
as matrices at HIGHEST precision), so they agree to float32 rounding:
atol 1e-5 on values of order 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.ops import resize as jres
from depthg_tpu_torch.ops import resize as tres

torch.set_num_threads(1)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(13, 11), (4, 5), 16])
def test_bilinear_matches_jax(align_corners, size):
    x = _x((2, 3, 7, 9))
    ref = jres.resize_bilinear(jnp.asarray(x), size, align_corners=align_corners)
    out = tres.resize_bilinear(torch.from_numpy(x), size, align_corners=align_corners)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_bilinear_fast_bf16_stays_bf16():
    x = np.random.default_rng(1).random((1, 4, 40, 40)).astype(np.float32)
    out = tres.resize_bilinear(torch.from_numpy(x).bfloat16(), (80, 80), fast=True)
    assert out.dtype == torch.bfloat16
    ref = jres.resize_bilinear(jnp.asarray(x), (80, 80))
    # bf16 keeps 8 bits: one rounding of values in [0, 1] is <= 2^-9
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref), atol=4e-3)


@pytest.mark.parametrize("side,out_px,ps", [(28, 64, 8), (28, 320, 8), (5, 48, 8)])
def test_bicubic_scale_quirk_matches_jax(side, out_px, ps):
    """The DINO pos-embed resize: explicit scale (px // ps + 0.1) / side."""
    x = _x((1, 6, side, side), seed=2)
    sf = ((out_px // ps + 0.1) / side, (out_px // ps + 0.1) / side)
    size = (int(side * sf[0]), int(side * sf[1]))
    ref = jres.resize_bicubic(jnp.asarray(x), size, scale=sf)
    out = tres.resize_bicubic(torch.from_numpy(x), size, scale=sf)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_bicubic_without_scale_matches_jax():
    x = _x((2, 3, 6, 7), seed=3)
    ref = jres.resize_bicubic(jnp.asarray(x), (11, 5))
    out = tres.resize_bicubic(torch.from_numpy(x), (11, 5))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(40, 40), (17, 23), (5, 6)])
def test_resized_sq_norm_matches_jax(align_corners, size):
    x = _x((2, 4, 5, 6), seed=4)
    ref = jres.resized_sq_norm(jnp.asarray(x), size, align_corners=align_corners)
    out = tres.resized_sq_norm(torch.from_numpy(x), size, align_corners=align_corners)
    # squared norms over 4 channels reach ~20: float32 rounding is relative
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-6, atol=1e-5)
    direct = (tres.resize_bilinear(torch.from_numpy(x), size,
                                   align_corners=align_corners) ** 2).sum(1)
    np.testing.assert_allclose(out.numpy(), direct.numpy(), rtol=2e-6, atol=1e-5)
