"""DINO ViT of the PyTorch port vs the JAX package.

A 2-block, 128-wide, 2-head ViT at 64 px (the 224 px pos-embed table is
resized through the bicubic scale quirk). Weights are made by the JAX
package and cross over through its ``vit_state_dict`` exporter, loaded with
``strict=True``. Float32 (JAX at ``precision="float32"``): atol 1e-4 on the
last block's features and qkv (same math, other reduction orders). bf16:
both frameworks cast params and image and use tanh GELU, but round at
different places; atol 3e-2 plus rtol 2e-2 (features reach |x| ~ 4, where
one bf16 step is 3e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from depthg_tpu.models import vit as jvit
from depthg_tpu.models.layers import cast_tree_bf16
from depthg_tpu.utils.ckpt import vit_state_dict
from depthg_tpu_torch.models import vit as tvit

torch.set_num_threads(1)

CFG = dict(embed_dim=128, depth=2, num_heads=2, patch_size=8)


@pytest.fixture(scope="module")
def models():
    jcfg = jvit.ViTConfig(**CFG)
    params = jvit.vit_init(jax.random.PRNGKey(0), jcfg)
    model = tvit.VisionTransformer(tvit.ViTConfig(**CFG))
    host = jax.tree.map(np.array, params)  # writable host copies
    sd = {k: v.float() for k, v in vit_state_dict(host).items()}
    model.load_state_dict(sd, strict=True)
    x = np.random.default_rng(0).standard_normal((2, 3, 64, 64)).astype(np.float32)
    return jcfg, params, model.eval(), x


def test_f32_matches_jax(models):
    jcfg, params, model, x = models
    fj, aj, qj = jvit.vit_apply(params, jnp.asarray(x), jcfg, n=1,
                                precision="float32", attn_impl="xla")
    with torch.no_grad():
        ft, at, qt = model(torch.from_numpy(x), n=1, attn_impl="xla")
    assert ft[0].shape == (2, 65, 128)
    np.testing.assert_allclose(ft[0].numpy(), np.asarray(fj[0]), atol=1e-4)
    np.testing.assert_allclose(qt[0].numpy(), np.asarray(qj[0]), atol=1e-4)
    np.testing.assert_allclose(at[0].numpy(), np.asarray(aj[0]), atol=1e-5)


def test_fused_path_equals_eager_on_cpu(models):
    """"fused" routes attention through ops.attention (its plain version on
    the CPU): same features as the eager path, no attention maps."""
    _, _, model, x = models
    with torch.no_grad():
        fx, _, _ = model(torch.from_numpy(x), attn_impl="xla")
        ff, af, _ = model(torch.from_numpy(x), attn_impl="fused")
    assert af[0] is None
    torch.testing.assert_close(ff[0], fx[0], rtol=0, atol=1e-5)


def test_bf16_matches_jax(models):
    jcfg, params, model, x = models
    fj, _, qj = jvit.vit_apply(cast_tree_bf16(params),
                               jnp.asarray(x, jnp.bfloat16), jcfg, n=1,
                               attn_impl="xla")
    bf = {k: p.bfloat16() for k, p in model.named_parameters()}
    with torch.no_grad():
        ft, _, qt = functional_call(model, bf, (torch.from_numpy(x).bfloat16(),),
                                    {"attn_impl": "xla"})
    assert ft[0].dtype == torch.bfloat16
    np.testing.assert_allclose(ft[0].float().numpy(),
                               np.asarray(fj[0], np.float32), rtol=2e-2, atol=3e-2)
    np.testing.assert_allclose(qt[0].float().numpy(),
                               np.asarray(qj[0], np.float32), rtol=2e-2, atol=3e-2)


def test_resolve_attn_impl():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tvit.resolve_attn_impl("auto", None, cuda) == "fused"
    assert tvit.resolve_attn_impl("auto", None, cpu) == "xla"
    assert tvit.resolve_attn_impl("auto", "float32", cuda) == "xla"
    assert tvit.resolve_attn_impl("xla", None, cuda) == "xla"
    assert tvit.resolve_attn_impl("flash", None, cpu) == "flash"
