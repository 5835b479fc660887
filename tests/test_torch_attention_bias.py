"""The attention kernel's per-head logit bias (BEiT) vs the JAX package, on the CPU.

``attention_qkv(..., bias=)`` runs its plain version here; it is held to
JAX ``whole_kv_mha_qkv(bias=...)`` (the packed head-pair Pallas kernel) and
``whole_kv_mha(bias=...)`` (split operands), both in interpret mode, at
N=256 with n_valid=200 (keys past 200 weigh 0, rows past 200 are 0), and
unpadded at N=200 against the first 200 rows; 2 heads of 64; q/k/v in
float32 and bf16, the bias in float32 and bf16.

Tolerances: float32 1e-5 absolute (measured ~1e-7). bf16: both sides round
P to bf16 before the product with v and the output to bf16, so they may
land one bf16 step apart: 1e-2 absolute on outputs of size ~1 and 5e-3 in
the relative error ||out - ref|| / ||ref|| (measured ~1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import depthg_tpu.ops.attention as jatt
from depthg_tpu_torch.ops import attention as tatt

TOL = {"float32": (1e-5, 1e-6), "bfloat16": (1e-2, 5e-3)}
HEADS, HD, N, NV = 2, 64, 256, 200


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jatt.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _inputs(dtype, bias_dtype, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((2, N, 3 * HEADS * HD)).astype(np.float32)
    bias = (2.0 * rng.standard_normal((HEADS, N, N))).astype(np.float32)
    return (jnp.asarray(qkv, dtype), jnp.asarray(bias, bias_dtype),
            torch.from_numpy(qkv).to(getattr(torch, dtype)),
            torch.from_numpy(bias).to(getattr(torch, bias_dtype)))


def _assert_close(got, ref, dtype):
    atol, rel = TOL[dtype]
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert np.abs(got - ref).max() <= atol
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
def test_packed_qkv_with_bias_matches_jax(dtype, bias_dtype):
    jqkv, jbias, tqkv, tbias = _inputs(dtype, bias_dtype)
    ref = jatt.whole_kv_mha_qkv(jqkv, HEADS, HD ** -0.5, NV, bias=jbias)
    got = tatt.attention_qkv(tqkv, HEADS, HD ** -0.5, NV, bias=tbias)
    assert got.dtype == tqkv.dtype and got.shape == (2, N, HEADS * HD)
    _assert_close(got[:, :NV], ref[:, :NV], dtype)
    assert torch.all(got[:, NV:] == 0) and np.all(np.asarray(ref[:, NV:]) == 0)
    # unpadded: N = n_valid = 200, the bias cut to [:, :200, :200]
    short = tatt.attention_qkv(tqkv[:, :NV], HEADS, HD ** -0.5, bias=tbias[:, :NV, :NV])
    _assert_close(short, ref[:, :NV], dtype)
    # the bias acts
    plain = tatt.attention_qkv(tqkv, HEADS, HD ** -0.5, NV)
    assert float((plain - got).float().norm() / got.float().norm()) > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_operands_with_bias_match_jax(dtype):
    """``attention_plain`` on [B, H, N, 64] vs JAX ``whole_kv_mha``."""
    jqkv, jbias, tqkv, tbias = _inputs(dtype, dtype, seed=1)
    jq, jk, jv = (jnp.transpose(jqkv.reshape(2, N, 3, HEADS, HD)[:, :, i], (0, 2, 1, 3))
                  for i in range(3))
    ref = jatt.whole_kv_mha(jq, jk, jv, HD ** -0.5, NV, bias=jbias)
    tq, tk, tv = tatt.split_qkv(tqkv, HEADS)
    got = tatt.attention_plain(tq, tk, tv, HD ** -0.5, NV, bias=tbias)
    _assert_close(got[:, :, :NV], ref[:, :, :NV], dtype)
    assert torch.all(got[:, :, NV:] == 0)


def test_bias_past_n_valid_is_ignored():
    _, _, tqkv, tbias = _inputs("float32", "float32", seed=2)
    out = tatt.attention_qkv(tqkv, HEADS, 0.125, NV, bias=tbias)
    tbias[:, :, NV:] = 1e4
    tbias[:, NV:] = float("nan")
    torch.testing.assert_close(tatt.attention_qkv(tqkv, HEADS, 0.125, NV, bias=tbias), out,
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape,dtype,match", [
    ((HEADS, N, N - 1), torch.float32, "bias must be"),
    ((HEADS + 1, N, N), torch.float32, "bias must be"),
    ((1, HEADS, N, N), torch.float32, "bias must be"),
    ((HEADS, N, N), torch.float64, "float32 or bfloat16"),
])
def test_bias_shape_and_dtype_errors(shape, dtype, match):
    qkv = torch.zeros(1, N, 3 * HEADS * HD)
    with pytest.raises(ValueError, match=match):
        tatt.attention_qkv(qkv, HEADS, 0.125, bias=torch.zeros(shape, dtype=dtype))


def test_kernel_path_refuses_a_cpu_bias_and_jax_refuses_the_same_shapes():
    """The launcher never runs the plain version (a CPU tensor raises), and
    the shape rule is the JAX package's."""
    qkv = torch.zeros(1, N, 3 * HEADS * HD)
    q, k, v = tatt.split_qkv(qkv, HEADS)
    with pytest.raises(ValueError, match="CUDA"):
        tatt._launch(q, k, v, torch.empty_like(q), 0.125, N, torch.zeros(HEADS, N, N))
    with pytest.raises(ValueError, match="bias must be"):
        jatt.whole_kv_mha_qkv(jnp.zeros((1, N, 3 * HEADS * HD)), HEADS, 0.125,
                              bias=jnp.zeros((HEADS, N, N - 1)))
