"""Attention of the PyTorch port vs the JAX package.

On the CPU the wrapper runs ``attention_plain``, the eager version of the
kernel's math; it is held against the JAX "xla" formulation and against the
Pallas kernels in interpret mode (as ``tests/test_attention_kernel.py``
runs them), at atol 1e-5 in float32 (same math, other reduction orders).
The Hopper kernel itself is held against ``attention_plain`` on the card
by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.ops.attention import whole_kv_mha, whole_kv_mha_qkv
from depthg_tpu_torch.ops import attention as tatt

torch.set_num_threads(1)


def _packed(b, n, heads, n_valid, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * heads * 64)).astype(np.float32)
    qkv[:, n_valid:] = 0.0
    return qkv


def _jax_xla(qkv, heads, scale, n_valid):
    b, n, d3 = qkv.shape
    q, k, v = jnp.transpose(jnp.asarray(qkv).reshape(b, n, 3, heads, 64),
                            (2, 0, 3, 1, 4))
    s = jnp.einsum("bhnd,bhmd->bhnm", q, k,
                   precision=jax.lax.Precision.HIGHEST) * scale
    s = jnp.where(jnp.arange(n) < n_valid, s, -jnp.inf)
    o = jnp.einsum("bhnm,bhmd->bhnd", jax.nn.softmax(s, axis=-1), v,
                   precision=jax.lax.Precision.HIGHEST)
    return np.asarray(jnp.transpose(o, (0, 2, 1, 3)).reshape(b, n, d3 // 3))


@pytest.mark.parametrize("heads", [2, 3])
@pytest.mark.parametrize("n,n_valid", [(128, 128), (128, 100), (384, 129), (384, 256),
                                       (384, 200)])
def test_plain_matches_jax(heads, n, n_valid):
    """Gaps of 128 rows and more too (384 against 129, 256, 200): whole
    64-row sub-tiles, and the second round of the kernel's 256-row block,
    past n_valid. Rows >= n_valid are exactly 0 on both sides."""
    qkv = _packed(2, n, heads, n_valid)
    out = tatt.attention_qkv(torch.from_numpy(qkv), heads, 0.125, n_valid).numpy()
    assert out.shape == (2, n, heads * 64)
    assert np.all(out[:, n_valid:] == 0.0)
    ref = _jax_xla(qkv, heads, 0.125, n_valid)
    np.testing.assert_allclose(out[:, :n_valid], ref[:, :n_valid], atol=1e-5)
    if heads % 2 == 0:  # K1: the head-pair Pallas kernel
        pal = whole_kv_mha_qkv(jnp.asarray(qkv), heads, 0.125, n_valid=n_valid,
                               interpret=True)
    else:  # K2: split operands (vit_tiny-like odd head count)
        q, k, v = jnp.transpose(jnp.asarray(qkv).reshape(2, n, 3, heads, 64),
                                (2, 0, 3, 1, 4))
        pal = jnp.transpose(whole_kv_mha(q, k, v, 0.125, n_valid=n_valid,
                                         interpret=True),
                            (0, 2, 1, 3)).reshape(2, n, heads * 64)
    pal = np.asarray(pal)
    assert np.all(pal[:, n_valid:] == 0.0)
    np.testing.assert_allclose(out, pal, atol=1e-5)


def test_masked_keys_have_no_influence():
    qkv = _packed(1, 128, 2, 100, seed=2)
    out = tatt.attention_qkv(torch.from_numpy(qkv), 2, 0.125, 100)
    qkv[:, 100:, 128:] = 1e4  # keys and values past n_valid
    out2 = tatt.attention_qkv(torch.from_numpy(qkv), 2, 0.125, 100)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "n_valid", "rank"])
def test_wrapper_rejects_what_kernel_cannot_take(bad):
    qkv = torch.zeros(1, 64, 3 * 128)
    kwargs = dict(qkv=qkv, num_heads=2, scale=0.125, n_valid=None)
    if bad == "head_dim":
        kwargs["num_heads"] = 4  # 32-wide heads
    elif bad == "dtype":
        kwargs["qkv"] = qkv.half()
    elif bad == "n_valid":
        kwargs["n_valid"] = 0
    else:
        kwargs["qkv"] = qkv[0]
    with pytest.raises(ValueError):
        tatt.attention_qkv(**kwargs)

