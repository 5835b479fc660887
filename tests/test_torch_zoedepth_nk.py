"""ZoeDepth-NK of the PyTorch port vs the JAX package, on the CPU.

The reduced configuration of ``tests/test_zoedepth_nk.py`` (``CFG``: BEiT
64 wide, 8 blocks, 8 bins per domain, a router of width 16), weights drawn
by the JAX package (``zoedepth_nk_init``) and carried over as the released
file's layout (``zoe_nk_state_dict_from_params``, loaded with
``strict=True``). Float32, JAX at "highest" matmul precision.

Tolerances: the domain index equal; metric depth 1e-4 relative to its
largest value (measured 3.7e-7), domain logits and relative depth 1e-4
(measured 1.2e-7); the router's parts 1e-5.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.models.zoedepth import nk as jnk
from depthg_tpu_torch.models.zoedepth import beit as tbeit
from depthg_tpu_torch.models.zoedepth import dpt as tdpt
from depthg_tpu_torch.models.zoedepth import nk as tnk
from depthg_tpu_torch.models.zoedepth.convert import zoe_nk_state_dict_from_params
from test_zoedepth_nk import CFG

torch.set_num_threads(2)


def port_nk_config(jcfg) -> tnk.ZoeNKConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["bin_confs"] = tuple(tnk.BinConf(*dataclasses.astuple(c)) for c in jcfg.bin_confs)
    # the attention path is the port's own default ("auto"), not JAX's "xla"
    fields["beit"] = tbeit.BEiTConfig(**{k: v for k, v in dataclasses.asdict(jcfg.beit).items()
                                         if k != "attn_impl"})
    fields["dpt"] = tdpt.DPTConfig(**dataclasses.asdict(jcfg.dpt))
    return tnk.ZoeNKConfig(**fields)


def _close(got, ref, rtol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, (what, err)


@pytest.fixture(scope="module")
def pair():
    params = jax.tree.map(lambda a: np.array(a, np.float32),
                          jnk.zoedepth_nk_init(jax.random.PRNGKey(0), CFG))
    model = tnk.ZoeDepthNK(port_nk_config(CFG))
    model.load_state_dict(zoe_nk_state_dict_from_params(params), strict=True)
    return params, model.eval()


@pytest.mark.parametrize("domain", [0, 1])
def test_nk_forward_matches_jax(pair, domain):
    """``zoedepth_nk_forward`` against ``ZoeDepthNK``: the same domain, its
    head's metric depth, the logits and the relative depth. The router's
    last bias is pushed towards ``domain`` in both packages, so each head
    runs once."""
    params, model = pair
    params, model = jax.tree.map(lambda a: a, params), copy.deepcopy(model)
    bias = params["router"]["cls2"]["b"].copy()
    bias[domain] += 50.0
    params["router"]["cls2"]["b"] = bias
    with torch.no_grad():
        model.mlp_classifier[2].bias.copy_(torch.from_numpy(bias))
    x = np.random.default_rng(domain).standard_normal((2, 3, 64, 64)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, x: jnk.zoedepth_nk_forward(p, x, CFG))(params, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    ref_domain = int(jnp.argmax(jax.nn.softmax(ref["domain_logits"].sum(axis=0))))
    assert tnk.domain_index(out["domain_logits"]) == ref_domain == domain
    _close(out["metric_depth"], ref["metric_depth"], 1e-4, "metric_depth")
    _close(out["domain_logits"], ref["domain_logits"], 1e-4, "domain_logits")
    np.testing.assert_allclose(out["rel_depth"].numpy(), np.asarray(ref["rel_depth"]),
                               rtol=1e-4, atol=1e-6)
    assert out["metric_depth"].shape == (2, 1, 64, 64) and float(out["metric_depth"].min()) >= 0


def test_router_parts_match_jax(pair):
    """The sinusoidal encoding, one post-norm encoder layer and the router
    up to the logits, on a random bottleneck."""
    params, model = pair
    np.testing.assert_allclose(tnk.positional_encoding_1d(12, 16).numpy(),
                               np.asarray(jnk._positional_encoding_1d(12, 16)), rtol=1e-6,
                               atol=1e-6)
    tok = np.random.default_rng(1).standard_normal((2, 12, 16)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jnk._encoder_layer(params["router"]["layers"][0], jnp.asarray(tok), CFG.router_heads)
        feat = np.random.default_rng(2).standard_normal((2, 32, 4, 4)).astype(np.float32)
        logits = jnk._router(params["router"], jnp.asarray(feat), CFG)
    with torch.no_grad():
        got = model.patch_transformer.transformer_encoder.layers[0](torch.from_numpy(tok))
        got_logits = model.mlp_classifier(model.patch_transformer(torch.from_numpy(feat))[:, 0])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), rtol=1e-5, atol=1e-5)


def test_nk_state_dict_names_and_full_width_size():
    """The converter's keys are exactly the module's (the released NK
    file's names), and at full width (``get_config("zoedepth_nk")``, built
    on the meta device) the port holds as many parameters as the JAX tree."""
    from depthg_tpu.models.zoedepth.config import get_config as jget_config
    from depthg_tpu_torch.models.zoedepth.config import get_config

    cfg = get_config("zoedepth_nk")
    with torch.device("meta"):
        model = tnk.ZoeDepthNK(cfg)
    shapes = jax.eval_shape(lambda: jnk.zoedepth_nk_init(jax.random.PRNGKey(0),
                                                          jget_config("zoedepth_nk")))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    names = set(model.state_dict())
    assert {"patch_transformer.transformer_encoder.layers.3.self_attn.in_proj_weight",
            "mlp_classifier.2.bias", "seed_bin_regressors.kitti._net.2.weight",
            "attractors.nyu.3._net.0.weight",
            "conditional_log_binomial.kitti.mlp.2.bias"} <= names
    assert model.conditional_log_binomial["nyu"].mlp[0].in_channels == 32 + 128
    assert model.conditional_log_binomial["nyu"].mlp[0].out_channels == (32 + 128) // 4


def test_nk_init_weights_is_finite_and_routes():
    """The port's own init (no JAX weights) gives a finite forward."""
    model = tnk.ZoeDepthNK(port_nk_config(CFG)).init_weights(torch.Generator().manual_seed(3))
    with torch.no_grad():
        out = model(torch.rand(1, 3, 64, 96, generator=torch.Generator().manual_seed(4)))
    assert torch.isfinite(out["metric_depth"]).all() and out["domain_logits"].shape == (1, 2)
    w = model.patch_transformer.transformer_encoder.layers[0].self_attn.in_proj_weight.detach()
    assert float(w.abs().max()) <= 1 / 16 ** 0.5 and float(w.std()) > 0.1
