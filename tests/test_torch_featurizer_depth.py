"""The depth-fused featurizer of the PyTorch port
(``depthg_tpu_torch/models/featurizer_depth.py``, ``arch=dino_depth``) vs
the JAX package's ``depthg_tpu/models/featurizer_depth.py``, on the CPU.

Weights come from the JAX package's init through ``state_dict_from_jax``;
inputs are seeded numpy arrays; the ViT is the JAX tests' tiny one (384
wide: the 3-stage depth pyramid lines up with the patch-8 grid only
there). Tolerances: the k=2 s=2 convolution, ``LayerNorm2d``, the depth
pyramid and the cross-attention 1e-5 relative (atol 1e-6); every output of
the featurizer 1e-5 relative (atol 1e-5) in each ``guidance`` mode, in
train and in eval mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.models import featurizer_depth as jfd
from depthg_tpu.models.vit import ViTConfig as JViTConfig
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.models import featurizer_depth as tfd
from depthg_tpu_torch.models.layers import MultiheadAttention
from depthg_tpu_torch.models.vit import ViTConfig as TViTConfig
from depthg_tpu_torch.utils.ckpt import state_dict_from_jax

torch.set_num_threads(1)
RNG = np.random.default_rng(11)
VIT = dict(patch_size=8, embed_dim=384, depth=2, num_heads=2, img_size=32)


def _pair(guidance="cross_attn", vit=VIT, seed=0, **kw):
    kw = dict(arch="vit_small", patch_size=8, dim=16, guidance=guidance,
              cross_attn_heads=4, dropout=False, drop_rate=0.0, cross_attn_dropout=0.0, **kw)
    jcfg = jfd.DepthFeaturizerConfig(vit_config=JViTConfig(**vit), **kw)
    tcfg = tfd.DepthFeaturizerConfig(vit_config=TViTConfig(**vit), **kw)
    params = jfd.depth_featurizer_init(jax.random.PRNGKey(seed), jcfg)
    sd = state_dict_from_jax({"net": params})
    net = tfeat.build(tcfg)
    assert isinstance(net, tfd.DinoDepthFeaturizer)
    net.load_state_dict({k[len("net."):]: v for k, v in sd.items()}, strict=True)
    return jcfg, params, net


def _close(out, ref, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def test_conv2x2_and_layer_norm_2d_match_jax():
    """Each pyramid stage's k=2 s=2 conv (JAX: [in*4, out] in (c, kh, kw)
    order, carried to torch's OIHW) and its channel layer norm."""
    _, params, net = _pair()
    for i, stage in enumerate(net.depth_downscaling):
        p = params["depth_downscaling"][i]
        cin = stage.conv.in_channels
        x = RNG.standard_normal((2, cin, 16, 16)).astype(np.float32)
        with torch.no_grad():
            y = stage.conv(torch.from_numpy(x))
            _close(y, jfd.conv2x2_s2(p["conv"], jnp.asarray(x)), atol=1e-5, what=f"conv {i}")
            if stage.ln is None:
                continue
            z = RNG.standard_normal(tuple(y.shape)).astype(np.float32) * 3 + 1
            _close(stage.ln(torch.from_numpy(z)), jfd.layer_norm_2d(p["ln"], jnp.asarray(z)),
                   what=f"LayerNorm2d {i}")
            assert stage.ln(torch.from_numpy(z).bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("n_feats,stages,side", [(384, 3, 28), (64, 5, 7)])
def test_depth_pyramid_matches_jax(n_feats, stages, side):
    """3 stages (8x down) at 384 wide, 5 (32x down) otherwise: the
    reference's quirk, kept."""
    vit = dict(VIT, embed_dim=n_feats)
    jcfg, params, net = _pair(vit=vit)
    assert len(net.depth_downscaling) == stages
    assert [s.ln is None for s in net.depth_downscaling] == [False] * (stages - 1) + [True]
    depth = RNG.random((1, 1, 224, 224)).astype(np.float32)
    ref = jfd.depth_pyramid(params, jnp.asarray(depth))
    with torch.no_grad():
        out = net.depth_pyramid(torch.from_numpy(depth))
    assert tuple(out.shape) == (1, n_feats, side, side)
    _close(out, ref, what="pyramid")


@pytest.mark.parametrize("drop", [0.0, 0.5])
def test_cross_attention_matches_jax(drop):
    """Depth tokens query the image tokens; with dropout the mask comes
    from the generator (same generator, same mask), and in eval none."""
    jcfg, params, net = _pair()
    q = RNG.standard_normal((2, 16, 384)).astype(np.float32)
    kv = RNG.standard_normal((2, 16, 384)).astype(np.float32)
    ref = jfd._multihead_attention(params["cross_attn"], jnp.asarray(q), jnp.asarray(kv),
                                   jnp.asarray(kv), 4, 0.0)
    with torch.no_grad():
        out = net.cross_attn(torch.from_numpy(q), torch.from_numpy(kv))
        _close(out, ref, atol=1e-5, what="cross attention")
        if drop:
            a = net.cross_attn(torch.from_numpy(q), torch.from_numpy(kv), drop,
                               torch.Generator().manual_seed(4))
            b = net.cross_attn(torch.from_numpy(q), torch.from_numpy(kv), drop,
                               torch.Generator().manual_seed(4))
            assert torch.equal(a, b) and not torch.allclose(a, out)
            with pytest.raises(ValueError, match="Generator"):
                net.cross_attn(torch.from_numpy(q), torch.from_numpy(kv), drop)


def test_multihead_attention_self_form_is_the_cross_form_on_itself():
    """ZoeDepth-NK's router (self-attention) and the cross-attention share
    one parameter layout and one forward."""
    attn = MultiheadAttention(32, 4)
    x = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(attn(x), attn(x, x), rtol=1e-6, atol=1e-6)
    assert sorted(attn.state_dict()) == ["in_proj_bias", "in_proj_weight",
                                         "out_proj.bias", "out_proj.weight"]


@pytest.mark.parametrize("guidance", ["none", "sum", "cross_attn"])
@pytest.mark.parametrize("train", [True, False])
def test_depth_featurizer_matches_jax(guidance, train):
    """Each guidance mode in train mode (with depth) and eval mode (none):
    "sum" fuses only in train mode, "cross_attn" queries with the depth
    tokens in train mode and with ``no_depth_embed`` in eval; only the
    train output carries ``orig_feats``."""
    jcfg, params, net = _pair(guidance)
    img = RNG.standard_normal((2, 3, 32, 32)).astype(np.float32)
    depth = RNG.random((2, 1, 32, 32)).astype(np.float32) if train else None
    ref = jfd.depth_featurizer_apply(params, jnp.asarray(img), jcfg,
                                     None if depth is None else jnp.asarray(depth),
                                     train=train, precision="float32")
    with torch.no_grad():
        out = tfeat.dispatch_apply(net, torch.from_numpy(img),
                                   None if depth is None else torch.from_numpy(depth),
                                   precision="float32", train=train)
    assert sorted(k for k in out if out[k] is not None) == sorted(
        k for k in ref if ref[k] is not None)
    assert ("orig_feats" in out) == train
    for key in ("feats", "code", "orig_feats", "attn"):
        if key in ref and ref[key] is not None:
            _close(out[key], ref[key], atol=1e-5, what=key)
    fused_differs = not np.allclose(np.asarray(ref["feats"]), np.asarray(
        jfd.depth_featurizer_apply(params, jnp.asarray(img), jcfg.__class__(
            **{**jcfg.__dict__, "guidance": "none"}), None, precision="float32")["feats"]))
    assert fused_differs == (guidance == "cross_attn" or (guidance == "sum" and train))


def test_concat_guidance_raises():
    _, _, net = _pair("concat")
    with pytest.raises(NotImplementedError, match="concat"):
        tfeat.dispatch_apply(net, torch.zeros(1, 3, 32, 32))


def test_random_init_is_seeded_and_keeps_the_dino_draws():
    """``init_weights`` draws from the generator alone: the same seed, the
    same weights; the ViT and projection head take the plain featurizer's
    draws first, so they equal a ``DinoFeaturizer`` from the same seed."""
    cfg = tfd.DepthFeaturizerConfig(vit_config=TViTConfig(**VIT), dim=16, guidance="sum")
    a = tfd.DinoDepthFeaturizer(cfg).init_weights(torch.Generator().manual_seed(2))
    b = tfd.DinoDepthFeaturizer(cfg).init_weights(torch.Generator().manual_seed(2))
    plain = tfeat.DinoFeaturizer(tfeat.FeaturizerConfig(
        vit_config=TViTConfig(**VIT), dim=16)).init_weights(torch.Generator().manual_seed(2))
    sa, sb, sp = a.state_dict(), b.state_dict(), plain.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(sa[k], sp[k]) for k in sp)
    assert float(a.no_depth_embed.std()) > 0.5
