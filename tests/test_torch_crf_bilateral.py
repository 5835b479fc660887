"""Streaming bilateral message of the port (``ops/crf_bilateral.py``, the
plain version of the K4 kernel) vs the JAX package and float64 numpy.

Inputs are made with numpy from a seed: a batch of 2 images of standard
normal features (as ``tests/test_crf_pallas.py``) or of fidelity-scene
features (x/67, y/67, rgb/3, colors up to ~85), and values in [0, 1) like
the mean-field distributions. Limits are on max |out - ref| / max |ref|:

* float64 numpy: 1e-5 in float32 (the port's log-kernel is the direct
  -|f_i - f_j|^2 / 2, no cancellation); in bf16 the kernel entries and
  the output are rounded to bf16 (2^-9 relative each), 1e-2;
* JAX ``bilateral_message_pallas`` in interpret mode (``pallas_call``
  patched as ``tests/test_crf_pallas.py`` does) and JAX
  ``_bilateral_message``: both compute the log-kernel as a.b - |a|^2/2 -
  |b|^2/2. On normal features (|f|^2 ~ 5) that costs nothing and the limit
  stays 1e-5 in float32; on scene features the terms reach ~2e4 and float32
  cancellation leaves ~1e-3 of noise per kernel entry, so the limit is
  2e-3 (both JAX forms measured 3.6e-4 from float64 there, the port
  3e-7). In bf16 the Pallas kernel keeps float32 entries (1e-2, the port's
  own rounding); ``_bilateral_message`` rounds its tile to bf16 as the port
  does but also adds its up to 2 x n / block - 1 tile products in bf16,
  which puts it up to ~1e-2 from float64 itself, so 2e-2.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.ops import crf as jcrf
from depthg_tpu.ops import crf_pallas as jpallas
from depthg_tpu_torch.ops import crf_bilateral as tbil

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "crf_fidelity_study",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "scripts", "crf_fidelity_study.py"))
fidelity = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fidelity)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F64_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# JAX _bilateral_message sums its tiles in the values' dtype
STREAMING_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """Pallas in interpret mode: the tests run on the CPU backend."""
    orig = jpallas.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jpallas.pl, "pallas_call", patched)


def _normal_inputs(n, c, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, n, 5)).astype(np.float32)
    values = rng.random((2, n, c)).astype(np.float32)
    return feats, values


def _scene_inputs(size=32, c=27):
    """[2, size^2, 5] features of two fidelity scenes at full resolution."""
    feats = []
    for seed in (0, 1):
        image = fidelity.make_scene(size, 27, seed=seed)[0]
        ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        f = np.concatenate([xs[None] / 67.0, ys[None] / 67.0, image / 3.0])
        feats.append(f.reshape(5, -1).T)
    values = np.random.default_rng(2).random((2, size * size, c))
    return np.stack(feats).astype(np.float32), values.astype(np.float32)


def _port(feats, values, dtype):
    out = tbil.bilateral_message(torch.from_numpy(feats),
                                 torch.from_numpy(values).to(DTYPES[dtype]))
    assert out.dtype == DTYPES[dtype] and out.shape == values.shape
    return out.float().numpy()


def _rounded(values, dtype):
    """The values as the port sees them (bf16-rounded), in float32."""
    return torch.from_numpy(values).to(DTYPES[dtype]).float().numpy()


def _float64(feats, values):
    f = feats.astype(np.float64)
    out = []
    for fb, vb in zip(f, values.astype(np.float64)):
        d = np.zeros((fb.shape[0], fb.shape[0]))
        for k in range(5):
            d += (fb[:, None, k] - fb[None, :, k]) ** 2
        out.append(np.exp(-0.5 * d) @ vb)
    return np.stack(out)


def _assert_rel_max(out, ref, tol):
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max error {err:.3e} of max |ref| > {tol}"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,c", [(300, 27), (1024, 5), (513, 12)])
def test_plain_matches_float64(n, c, dtype):
    feats, values = _normal_inputs(n, c)
    want = _float64(feats, _rounded(values, dtype))
    _assert_rel_max(_port(feats, values, dtype), want, F64_TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,c", [(300, 27), (1024, 5), (513, 12)])
def test_plain_matches_jax_pallas_interpret(n, c, dtype):
    feats, values = _normal_inputs(n, c, seed=1)
    vr = _rounded(values, dtype)
    ref = np.stack([np.asarray(jpallas.bilateral_message_pallas(
        jnp.asarray(fb), jnp.asarray(vb))) for fb, vb in zip(feats, vr)])
    _assert_rel_max(_port(feats, values, dtype), ref, F64_TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,c", [(300, 27), (1024, 5), (513, 12)])
def test_plain_matches_jax_streaming(n, c, dtype):
    """JAX ``_bilateral_message`` at block 128: several symmetric diagonals
    and a padded last block (300 and 513 are not multiples of 128)."""
    feats, values = _normal_inputs(n, c, seed=2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.stack([np.asarray(jcrf._bilateral_message(
        jnp.asarray(fb), jnp.asarray(vb).astype(jdt), 128)).astype(np.float32)
        for fb, vb in zip(feats, values)])
    _assert_rel_max(_port(feats, values, dtype), ref, STREAMING_TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_scene_features(dtype):
    """Colors up to ~85: the port stays at float32 rounding of float64, the
    JAX forms carry their cancellation noise (limit 2e-3 in float32)."""
    feats, values = _scene_inputs()
    out = _port(feats, values, dtype)
    vr = _rounded(values, dtype)
    _assert_rel_max(out, _float64(feats, vr), F64_TOL[dtype])
    scene_tol = 2e-3 if dtype == "float32" else F64_TOL[dtype]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for fb, vb, ob in zip(feats, vr, out):
        pallas = np.asarray(jpallas.bilateral_message_pallas(jnp.asarray(fb),
                                                             jnp.asarray(vb)))
        streaming = np.asarray(jcrf._bilateral_message(
            jnp.asarray(fb), jnp.asarray(vb).astype(jdt), 256)).astype(np.float32)
        _assert_rel_max(ob, pallas, scene_tol)
        _assert_rel_max(ob, streaming, max(scene_tol, STREAMING_TOL[dtype]))


def test_plain_rows_blocked_like_whole(monkeypatch):
    """Row blocks of the plain version (37 rows here, a ragged last block)
    give the whole product up to float32 summation order."""
    feats, values = _normal_inputs(300, 7, seed=3)
    whole = _port(feats, values, "float32")
    monkeypatch.setattr(tbil, "BLOCK_ELEMS", 2 * 300 * 37)
    _assert_rel_max(_port(feats, values, "float32"), whole, 1e-6)


def test_wrapper_checks_shapes():
    feats = torch.zeros(2, 10, 5)
    with pytest.raises(ValueError, match="feats"):
        tbil.bilateral_message(torch.zeros(2, 10, 4), torch.zeros(2, 10, 3))
    with pytest.raises(ValueError, match="values"):
        tbil.bilateral_message(feats, torch.zeros(2, 11, 3))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tbil.bilateral_message(feats, torch.zeros(2, 10, 3, dtype=torch.float64))


@pytest.mark.parametrize("inputs", ["normal", "scene"])
def test_degree_matches_float64_and_jax(inputs):
    """``bilateral_degree`` (K @ 1, float32; on the CPU the plain version on
    ones) vs float64 numpy and the JAX package's streaming message on ones."""
    feats, _ = _normal_inputs(300, 1) if inputs == "normal" else _scene_inputs(24, 1)
    out = tbil.bilateral_degree(torch.from_numpy(feats))
    assert out.shape == (*feats.shape[:2], 1) and out.dtype == torch.float32
    f64 = feats.astype(np.float64)
    d = ((f64[:, :, None] - f64[:, None]) ** 2).sum(-1)
    ref = np.exp(-0.5 * d).sum(-1, keepdims=True)
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    ones = np.ones((*feats.shape[:2], 1), np.float32)
    for b in range(feats.shape[0]):
        jref = np.asarray(jcrf._bilateral_message(jnp.asarray(feats[b]), jnp.asarray(ones[b]),
                                                  block=128))
        tol = 1e-5 if inputs == "normal" else 2e-3
        assert np.abs(out[b].numpy() - jref).max() <= tol * np.abs(jref).max()


def test_degree_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="float32 feats"):
        tbil.bilateral_degree(torch.zeros(1, 8, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="feats"):
        tbil.bilateral_degree(torch.zeros(1, 8, 4))
    with pytest.raises(ValueError, match="feats"):
        tbil.bilateral_degree(torch.zeros(1, 0, 5))
