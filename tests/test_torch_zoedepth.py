"""ZoeDepth of the PyTorch port vs the JAX package, on the CPU.

A BEiT cut to 4 blocks of width 128 (2 heads of 64: the port's attention
kernel and its plain version take head_dim 64 only), pretraining window 4,
so a 64 x 96 input (a 4 x 6 patch grid) resizes the relative-position
table; LayerScale at 0.1 so that attention shows in the output (at the
default 1e-5 every block is nearly the identity). The JAX package draws
the weights (``zoedepth_init``); they cross over as the released file's
state dict (``zoe_state_dict_from_params``) and load with ``strict=True``.
The JAX package resizes the table bicubically, so the port runs here with
``rel_pos_resize="bicubic"`` (its default is MiDaS 3.1's bilinear resize,
held to the plain reference in ``test_torch_zoedepth_reference.py``).

Float32 throughout, JAX at "highest" matmul precision. Tolerances: taps
2e-5 absolute and relative, as the JAX package's own fused-vs-xla test
(measured ~2e-6); decoder hooks and head tensors 1e-4 relative to their
largest value; metric depth 1e-4 relative (measured ~1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.models.zoedepth import beit as jbeit
from depthg_tpu.models.zoedepth import heads as jheads
from depthg_tpu.models.zoedepth import model as jmodel
from depthg_tpu.models.zoedepth.convert import zoe_config_from_params, zoe_params_from_torch
from depthg_tpu.models.zoedepth.dpt import DPTConfig as JDPTConfig
from depthg_tpu.models.zoedepth.dpt import dpt_forward
from depthg_tpu_torch.models.zoedepth import beit as tbeit
from depthg_tpu_torch.models.zoedepth import heads as theads
from depthg_tpu_torch.models.zoedepth import model as tmodel
from depthg_tpu_torch.models.zoedepth.convert import (zoe_config_from_state_dict,
                                                      zoe_state_dict_from_params)
from depthg_tpu_torch.models.zoedepth.dpt import DPTConfig as TDPTConfig

torch.set_num_threads(2)

JCFG = jmodel.ZoeConfig(
    n_bins=8, bin_embedding_dim=16, n_attractors=(4, 3, 2, 1), img_size=(64, 96),
    beit=jbeit.BEiTConfig(embed_dim=128, depth=4, num_heads=2, pretrain_window=4,
                          hooks=(0, 1, 2, 3), layer_scale_init=0.1),
    dpt=JDPTConfig(embed_dim=128, features=32, reassemble_channels=(16, 32, 64, 64)))


def port_config(jcfg) -> tmodel.ZoeConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    # the attention path is the port's own default ("auto"), not JAX's "xla"
    fields["beit"] = tbeit.BEiTConfig(**{k: v for k, v in dataclasses.asdict(jcfg.beit).items()
                                         if k != "attn_impl"}, rel_pos_resize="bicubic")
    fields["dpt"] = TDPTConfig(**dataclasses.asdict(jcfg.dpt))
    return tmodel.ZoeConfig(**fields)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def models():
    params = _np_tree(jmodel.zoedepth_init(jax.random.PRNGKey(0), JCFG))
    model = tmodel.ZoeDepth(port_config(JCFG))
    model.load_state_dict(zoe_state_dict_from_params(params), strict=True)
    x = np.random.default_rng(0).random((2, 3, 64, 96)).astype(np.float32)
    return params, model.eval(), x


def _close(got, ref, rtol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, (what, err)
    return err


def _interpret(monkeypatch):
    """The JAX package's Pallas attention kernels in interpret mode."""
    from jax.experimental import pallas as pl

    import depthg_tpu.ops.attention as att

    orig = pl.pallas_call
    monkeypatch.setattr(att.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_beit_taps_match_jax(models, monkeypatch, impl):
    """Taps of every block: the port's eager path vs JAX's einsum path, and
    the port's kernel path (its plain version on the CPU: bias added after
    the scale, q x scale rounded first) vs JAX's whole-KV Pallas kernel in
    interpret mode (the stack padded to 128 tokens, the bias zero-padded)."""
    params, model, x = models
    _interpret(monkeypatch)
    xn = (x - 0.5) / 0.5
    with jax.default_matmul_precision("highest"):
        ref, grid = jbeit.beit_forward(params["beit"], jnp.asarray(xn),
                                       dataclasses.replace(JCFG.beit, attn_impl=impl))
    with torch.no_grad():
        taps, tgrid = model.core.core.pretrained.model(torch.from_numpy(xn), attn_impl=impl)
    assert tgrid == grid == (4, 6) and len(taps) == 4
    for got, want in zip(taps, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_relative_position_bias_matches_jax(models):
    """The resized, gathered [heads, N, N] bias, and its padded storage."""
    params, model, _ = models
    table = params["beit"]["blocks"][1]["rel_pos_table"]
    ref = jbeit._rel_pos_bias(jnp.asarray(table), JCFG.beit, 4, 6)
    got = tbeit.relative_position_bias(torch.from_numpy(table), 4, 4, 6, "bicubic")
    assert got.shape == (2, 25, 25) and got.stride() == (25 * 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    same = tbeit.relative_position_bias(torch.from_numpy(table), 4, 4, 4)
    np.testing.assert_array_equal(same.numpy(),
                                  np.asarray(jbeit._rel_pos_bias(jnp.asarray(table),
                                                                 JCFG.beit, 4, 4)))


def test_bias_cache_follows_the_table(models):
    """Built once per input size while gradients are off; an in-place change
    of the table (a load) builds it anew; with gradients on it is not kept."""
    _, model, _ = models
    attn = model.core.core.pretrained.model.blocks[0].attn
    with torch.no_grad():
        a = attn.rel_pos_bias(4, 6)
        assert attn.rel_pos_bias(4, 6) is a
        table = attn.relative_position_bias_table
        kept = table.clone()
        table.add_(1.0)
        b = attn.rel_pos_bias(4, 6)
        table.copy_(kept)
    assert b is not a and torch.allclose(b, a + 1.0)
    assert attn.rel_pos_bias(4, 6).requires_grad


def test_dpt_hooks_match_jax(models):
    params, model, x = models
    xn = jnp.asarray((x - 0.5) / 0.5)
    with jax.default_matmul_precision("highest"):
        taps, grid = jbeit.beit_forward(params["beit"], xn, JCFG.beit)
        rel, hooks = dpt_forward(params["dpt"], taps, grid, JCFG.dpt)
    dpt = model.core.core
    with torch.no_grad():
        ttaps, tgrid = dpt.pretrained.model(torch.from_numpy(np.array(xn)))
        trel, thooks = dpt.decode(ttaps, tgrid)
    assert set(thooks) == set(hooks) == {"l4_rn", "r4", "r3", "r2", "r1", "out_conv"}
    for name in hooks:
        _close(thooks[name], hooks[name], 1e-4, name)
    _close(trel, rel, 1e-4, "rel_depth")
    assert thooks["out_conv"].shape == (2, 32, 64, 96)


def _load_mlp(module, convs):
    with torch.no_grad():
        for slot, conv in zip((0, 2), convs):
            module[slot].weight.copy_(torch.from_numpy(conv["w"]))
            module[slot].bias.copy_(torch.from_numpy(conv["b"]))


@pytest.mark.parametrize("normed", [False, True])
@pytest.mark.parametrize("attractor_type,kind", [("inv", "mean"), ("exp", "sum")])
def test_attractors_match_jax(normed, attractor_type, kind):
    """Softplus and normed attractor layers, with both reference quirks
    (alpha=300, gamma=2 whatever is configured; channel 0 of the normed
    output taken unnormalized)."""
    rng = np.random.default_rng(1)
    n_attr, emb = 3, 16
    out_ch = 2 * n_attr if normed else n_attr
    convs = [{"w": rng.standard_normal((8, emb, 1, 1)).astype(np.float32) * 0.3,
              "b": rng.standard_normal(8).astype(np.float32) * 0.1},
             {"w": rng.standard_normal((out_ch, 8, 1, 1)).astype(np.float32) * 0.3,
              "b": rng.standard_normal(out_ch).astype(np.float32) * 0.1}]
    x = rng.standard_normal((2, emb, 6, 8)).astype(np.float32)
    prev_emb = rng.standard_normal((2, emb, 3, 4)).astype(np.float32)
    b_prev = rng.random((2, 5, 3, 4)).astype(np.float32) * (1.0 if normed else 4.0)
    fn = jheads.attractor_normed if normed else jheads.attractor_softplus
    extra = {"min_depth": 1e-3, "max_depth": 10.0} if normed else {}
    ref = fn(convs, jnp.asarray(x), jnp.asarray(b_prev), jnp.asarray(prev_emb), alpha=1000.0,
             gamma=2.0, kind=kind, attractor_type=attractor_type, **extra)
    layer = theads.Attractor(emb, out_ch, mid=8)
    _load_mlp(layer._net, convs)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(b_prev), torch.from_numpy(prev_emb),
                    kind=kind, attractor_type=attractor_type, normed=normed,
                    min_depth=1e-3, max_depth=10.0)
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)


@pytest.mark.parametrize("kind", ["softplus", "normed"])
def test_seed_bin_regressor_matches_jax(kind):
    rng = np.random.default_rng(2)
    convs = [{"w": rng.standard_normal((8, 4, 1, 1)).astype(np.float32),
              "b": rng.standard_normal(8).astype(np.float32)},
             {"w": rng.standard_normal((5, 8, 1, 1)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}]
    x = rng.standard_normal((2, 4, 3, 5)).astype(np.float32)
    if kind == "softplus":
        ref = jheads.seed_bin_regressor_softplus(convs, jnp.asarray(x))
    else:
        ref = jheads.seed_bin_regressor_normed(convs, jnp.asarray(x), 1e-3, 10.0)
    layer = theads.SeedBinRegressor(4, 5, mid=8)
    _load_mlp(layer._net, convs)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), kind, 1e-3, 10.0)
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)


def test_log_binomial_matches_jax_and_sums_to_one():
    rng = np.random.default_rng(3)
    probs = rng.random((2, 1, 4, 5)).astype(np.float32)
    probs[0, 0, 0, :2] = (0.0, 1.0)  # the clamps at both ends
    t = rng.random((2, 1, 4, 5)).astype(np.float32) * 3 + 0.05
    ref = jheads.log_binomial(jnp.asarray(probs), jnp.asarray(t), 64)
    got = theads.log_binomial(torch.from_numpy(probs), torch.from_numpy(t), 64)
    # 5e-5: temperatures down to 0.05 multiply the float32 roundings of the
    # log terms (|y| ~ 300) by 20 before the softmax (measured 1.3e-5)
    _close(got, ref, 5e-5)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5)
    # under bf16 inputs the float32 k grid promotes the result to float32, as in JAX
    got16 = theads.log_binomial(torch.from_numpy(probs).bfloat16(), torch.from_numpy(t).bfloat16(), 8)
    ref16 = jheads.log_binomial(jnp.asarray(probs, jnp.bfloat16), jnp.asarray(t, jnp.bfloat16), 8)
    assert got16.dtype == torch.float32 and ref16.dtype == jnp.float32


def test_conditional_log_binomial_matches_jax(models):
    params, model, _ = models
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 33, 6, 8)).astype(np.float32)
    cond = rng.standard_normal((2, 16, 6, 8)).astype(np.float32)
    ref = jheads.conditional_log_binomial(params["conditional_log_binomial"], jnp.asarray(x),
                                          jnp.asarray(cond), 8, JCFG.min_temp, JCFG.max_temp)
    with torch.no_grad():
        got = model.conditional_log_binomial(torch.from_numpy(x), torch.from_numpy(cond))
    _close(got, ref, 1e-5)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5)


def test_zoedepth_forward_matches_jax(models):
    """Metric depth, bin embedding (feats) and probabilities of the whole
    model on the prep-normalized input."""
    params, model, x = models
    xn = (x - 0.5) / 0.5
    with jax.default_matmul_precision("highest"):
        ref = jmodel.zoedepth_forward(params, jnp.asarray(xn), JCFG, return_probs=True)
    with torch.no_grad():
        out = model(torch.from_numpy(xn), return_probs=True)
    assert out["metric_depth"].shape == (2, 1, 64, 96)
    for name in ("rel_depth", "metric_depth", "feats", "probs", "bin_centers"):
        _close(out[name], ref[name], 1e-4, name)
    np.testing.assert_allclose(out["probs"].sum(1).numpy(), 1.0, atol=1e-5)


def test_zoedepth_infer_matches_jax(models):
    """Reflect pad (int(sqrt(h / 2) x 3)), prep resize, bicubic back, crop,
    and the flip TTA, averaged: depth and feats."""
    params, model, x = models
    with jax.default_matmul_precision("highest"):
        ref_d, ref_f = jmodel.zoedepth_infer(params, jnp.asarray(x), JCFG, return_feats=True)
        ref_once = jmodel.zoedepth_infer(params, jnp.asarray(x), JCFG, pad_input=False,
                                         with_flip_aug=False)
    with torch.no_grad():
        got_d, got_f = tmodel.zoedepth_infer(model, torch.from_numpy(x), return_feats=True)
        got_once = tmodel.zoedepth_infer(model, torch.from_numpy(x), pad_input=False,
                                         with_flip_aug=False)
    assert got_d.shape == (2, 1, 64, 96)
    _close(got_d, ref_d, 1e-4, "depth")
    _close(got_f, ref_f, 1e-4, "feats")
    _close(got_once, ref_once, 1e-4, "depth without pad and flip")


def test_prep_size_matches_jax_over_a_grid():
    """``prep_size`` (a numpy copy, ``np.round`` included) at every method
    over a grid of sizes and two targets."""
    for img_size in ((384, 512), (64, 96)):
        jcfg, tcfg = jmodel.ZoeConfig(img_size=img_size), tmodel.ZoeConfig(img_size=img_size)
        for h in range(40, 900, 37):
            for w in range(40, 900, 53):
                for method in ("minimal", "lower_bound", "upper_bound"):
                    assert tmodel.prep_size(h, w, tcfg, resize_method=method) == \
                        jmodel.prep_size(h, w, jcfg, resize_method=method), (h, w, method)
                assert tmodel.prep_size(h, w, tcfg, keep_aspect_ratio=False) == \
                    jmodel.prep_size(h, w, jcfg, keep_aspect_ratio=False)


def _assert_trees_equal(a, b, path="params"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        assert np.asarray(a).shape == np.asarray(b).shape, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("module_prefix", [False, True])
def test_carry_over_round_trips_through_the_jax_converter(models, module_prefix):
    """params -> ``zoe_state_dict_from_params`` -> the JAX package's own
    ``zoe_params_from_torch`` gives the original tree back, exactly (also
    with DataParallel's ``module.`` prefix and the file's ``model`` entry)."""
    params, _, _ = models
    sd = zoe_state_dict_from_params(params)
    if module_prefix:
        sd = {"model": {"module." + k: v for k, v in sd.items()}}
    _assert_trees_equal(zoe_params_from_torch(sd), params)


def test_load_zoedepth_pt_strict(models, tmp_path):
    """A file in the released layout loads with ``strict=True`` into a model
    of the derived configuration, equal to the fixture's but for the table's
    resize, which a file does not hold: it loads as the released model's
    bilinear one, set here to the fixture's bicubic one for the comparison."""
    from depthg_tpu_torch.models.zoedepth.convert import load_zoedepth_pt

    params, model, x = models
    sd = zoe_state_dict_from_params(params)
    sd["core.core.pretrained.model.blocks.0.attn.relative_position_index"] = torch.zeros(1)
    path = tmp_path / "zoe.pt"
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, path)
    loaded = load_zoedepth_pt(str(path)).eval()
    assert loaded.cfg.beit.rel_pos_resize == "bilinear"
    for block in loaded.core.core.pretrained.model.blocks:
        block.attn.resize = "bicubic"
    xn = torch.from_numpy((x - 0.5) / 0.5)
    with torch.no_grad():
        torch.testing.assert_close(loaded(xn)["metric_depth"], model(xn)["metric_depth"],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("features", [32, 48])
def test_config_from_state_dict_matches_jax(features):
    """``zoe_config_from_state_dict`` vs JAX ``zoe_config_from_params`` on
    the same weights: every field equal, except that the port reads
    ``n_midas_out`` from the log-binomial's input (always the decoder's 32
    channels) where JAX copies ``conv2``'s width (``features``): the two
    agree at features=32 only; and a state dict does not hold the table's
    resize, which the port reads as the released model's bilinear one."""
    jcfg = dataclasses.replace(JCFG, dpt=dataclasses.replace(JCFG.dpt, features=features))
    params = _np_tree(jmodel.zoedepth_init(jax.random.PRNGKey(1), jcfg))
    ref = zoe_config_from_params(params)
    got = zoe_config_from_state_dict(zoe_state_dict_from_params(params))
    assert got.n_midas_out == 32 and ref.n_midas_out == features
    assert got.dpt.project_readout
    want = port_config(ref)
    assert got == dataclasses.replace(
        want, n_midas_out=32, beit=dataclasses.replace(want.beit, rel_pos_resize="bilinear"))
