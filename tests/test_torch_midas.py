"""MiDaS DPT_Large of the PyTorch port vs the JAX package, on the CPU.

A ViT cut to 4 blocks of width 128 (2 heads of 64) with a 64 px position
table, on a non-square 96 x 64 input so that the bilinear position-embedding
resize runs. The JAX package draws the weights (``midas_dpt_init``); they
cross over as the torch-hub file's state dict
(``midas_state_dict_from_params``) and load with ``strict=True``. Float32,
JAX at "highest" matmul precision; relative depth and the six hooks within
1e-4 of their largest value (measured ~1e-6), through both the eager and
the kernel path (its plain version here; JAX's Pallas kernel in interpret
mode).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.models import midas_dpt as jmidas
from depthg_tpu_torch.models import midas_dpt as tmidas
from depthg_tpu_torch.models.zoedepth.convert import (load_midas_dpt,
                                                      midas_config_from_state_dict,
                                                      midas_state_dict_from_params)

torch.set_num_threads(2)

JCFG = jmidas.MidasDPTConfig(patch_size=16, embed_dim=128, depth=4, num_heads=2,
                             hooks=(0, 1, 2, 3), img_size=64, features=32,
                             reassemble_channels=(16, 32, 64, 64))


@pytest.fixture(scope="module")
def models():
    params = jax.tree.map(lambda a: np.array(a, np.float32),
                          jmidas.midas_dpt_init(jax.random.PRNGKey(0), JCFG))
    model = tmidas.MidasDPT(tmidas.MidasDPTConfig(**dataclasses.asdict(JCFG)))
    model.load_state_dict(midas_state_dict_from_params(params), strict=True)
    x = np.random.default_rng(0).random((2, 3, 96, 64)).astype(np.float32)
    return params, model.eval(), x


def _close(got, ref, rtol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, (what, err)


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_midas_forward_matches_jax(models, monkeypatch, impl):
    from jax.experimental import pallas as pl

    import depthg_tpu.ops.attention as att

    orig = pl.pallas_call
    monkeypatch.setattr(att.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    params, model, x = models
    with jax.default_matmul_precision("highest"):
        ref_d, ref_h = jmidas.midas_dpt_forward(params, jnp.asarray(x), JCFG, attn_impl=impl)
    with torch.no_grad():
        got_d, got_h = model(torch.from_numpy(x), attn_impl=impl)
    assert got_d.shape == (2, 96, 64)
    _close(got_d, ref_d, 1e-4, "rel_depth")
    assert set(got_h) == set(ref_h)
    for name in ref_h:
        _close(got_h[name], ref_h[name], 1e-4, name)


def test_pos_embed_resize_matches_jax(models):
    params, _, _ = models
    pos = params["vit"]["pos_embed"]
    for gh, gw in ((6, 4), (4, 4), (3, 7)):
        ref = jmidas._resize_pos_embed(jnp.asarray(pos), gh, gw)
        got = tmidas.resize_pos_embed(torch.from_numpy(pos), gh, gw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _flatten(tree, path="p"):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}[{i}]")
    else:
        yield path, tree


def test_carry_over_round_trips_through_the_jax_converter(models):
    """params -> ``midas_state_dict_from_params`` -> the JAX package's
    ``midas_dpt_from_torch`` gives the original tree back, exactly."""
    params, _, _ = models
    back = dict(_flatten(jmidas.midas_dpt_from_torch(midas_state_dict_from_params(params))))
    ref = dict(_flatten(params))
    assert set(back) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(np.asarray(back[key]), val, err_msg=key)


def test_load_midas_dpt_strict(models, tmp_path):
    """A hub-layout file (with the ViT's classifier head, which DPT never
    runs) loads with ``strict=True`` into the derived configuration."""
    params, model, x = models
    sd = midas_state_dict_from_params(params)
    cfg = midas_config_from_state_dict(sd)
    assert cfg == model.cfg
    sd["pretrained.model.head.weight"] = torch.zeros(10, 128)
    sd["pretrained.model.head.bias"] = torch.zeros(10)
    torch.save(sd, tmp_path / "dpt.pt")
    loaded = load_midas_dpt(str(tmp_path / "dpt.pt")).eval()
    with torch.no_grad():
        torch.testing.assert_close(loaded(torch.from_numpy(x))[0], model(torch.from_numpy(x))[0],
                                   rtol=0, atol=0)
