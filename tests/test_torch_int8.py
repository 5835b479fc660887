"""The int8 (w8a8) backbone of the PyTorch port vs the JAX package, on the CPU.

* The w8a8 linear (``models/layers.py``) against ``quantize_linear_params``
  and ``_linear_w8a8`` on seeded numpy inputs: the int8 weight codes, the
  weight scales, the activation codes and scales and the int32 sums are
  bit-equal (both round half to even, both divide by 127, ``torch._int_mm``
  on the CPU is the exact integer product); the float32 output is held to
  one float32 rounding of the rescale (XLA may fuse ``y * s + b`` into one
  FMA), and a bf16 output to one bf16 step. All-zero rows give exactly 0,
  and fewer than 17 rows (padded with zero rows for ``_int_mm``) give the
  rows of the unpadded product.
* The quantized ViT and BEiT against ``quantize_vit_params`` and
  ``quantize_beit_params``: the same linears quantized alike, the folded
  qkv bias, everything else bf16 with the same values.
* Features: a 2-block ViT through ``backbone_features(..., "int8")`` and a
  4-block BEiT's taps against JAX. Both packages run the same bf16 graph
  but round at other places (the layer norm's and softmax's float32 steps
  return to bf16 at other points, bf16 GELU, the bicubic table resize), so
  an activation code can flip at its .5 point; held to 3e-2 absolute plus
  2e-2 relative, the bf16 ViT test's bound (features reach |x| ~ 4, where
  one bf16 step is 3e-2), and the BEiT taps to 2e-2 of their largest
  value.
* Fidelity: cosine > 0.99 against the float32 forward, the JAX package's
  bound (``tests/test_int8_backbone.py``).
* The int8 copy is derived once per set of weights and again after an
  in-place update.
* Three int8 train steps against JAX ``train_step`` with
  ``backbone_dtype="int8"`` (``tests/test_torch_train_step.py``'s harness,
  a 32-wide ViT). The frozen features differ by bf16 roundings, which the
  loss and its gradients amplify: the port's bf16 backbone against JAX's
  bf16 on the same harness agrees to 1.0e-2 relative on the logs, 4.0e-2
  relative (in norm, per tensor) on the step-1 gradients and 1.3e-3 on
  the parameters after three steps; int8 measured 6.1e-3, 3.6e-2 and
  2.0e-3. Held to 2e-2, 5e-2 and 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.models import featurizer as jfeat
from depthg_tpu.models import vit as jvit
from depthg_tpu.models.layers import _linear_w8a8, quantize_linear_params
from depthg_tpu.utils.ckpt import vit_state_dict
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.models import layers as tl
from depthg_tpu_torch.models import vit as tvit

torch.set_num_threads(1)

VIT = dict(embed_dim=128, depth=2, num_heads=2, patch_size=8)


def _linear_pair(seed, k, n, bias=True):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero output channel: its scale clamps at 1e-12 / 127
    b = rng.standard_normal(n).astype(np.float32) if bias else np.zeros(n, np.float32)
    lin = torch.nn.Linear(k, n, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        if bias:
            lin.bias.copy_(torch.from_numpy(b))
    return quantize_linear_params({"w": jnp.asarray(w), "b": jnp.asarray(b)}), lin


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,n", [((5, 17, 64), 96), ((3, 40), 384), ((2, 7, 32), 24)])
def test_w8a8_linear_bit_equal_to_jax(shape, n, dtype):
    """Codes, scales and int32 sums equal JAX's; the output within one
    rounding of the rescale (float32) or one bf16 step."""
    jp, lin = _linear_pair(sum(shape) + n, shape[-1], n)
    q = tl.quantize_linear(lin)
    assert q.w_q.dtype == torch.int8 and q.s_w.dtype == q.b.dtype == torch.float32
    np.testing.assert_array_equal(q.w_q.numpy(), np.asarray(jp["w_q"]).T)
    np.testing.assert_array_equal(q.s_w.numpy(), np.asarray(jp["s_w"]))
    np.testing.assert_array_equal(q.b.numpy(), np.asarray(jp["b"]))

    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    x[..., 0, :] = 0.0  # whole rows of zeros
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    # the JAX recipe, step by step
    xf = jx.astype(jnp.float32)
    s_ref = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) / 127.0
    codes_ref = jnp.round(xf / s_ref).astype(jnp.int8)
    sums_ref = jax.lax.dot_general(codes_ref, jp["w_q"], (((x.ndim - 1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    codes, s_x = tl.quantize_rows(tx)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_ref))
    np.testing.assert_array_equal(s_x.numpy(), np.asarray(s_ref))
    sums = tl.int8_matmul(codes.reshape(-1, shape[-1]), q.w_q)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), np.asarray(sums_ref).reshape(-1, n))

    out = q(tx)
    ref = np.asarray(_linear_w8a8(jp, jx).astype(jnp.float32))
    assert out.dtype == tx.dtype and out.shape == (*shape[:-1], n)
    got = out.float().numpy()
    step = 2.0 ** -23 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_array_less(np.abs(got - ref), step * np.abs(ref) + 1e-30 + 1e-12)


def test_w8a8_zero_rows_and_padded_rows_are_exact():
    """All-zero rows give exactly 0 (with a zero bias); a product of fewer
    than 17 rows (padded to 32 zero rows) equals those rows of a larger one."""
    _, lin = _linear_pair(3, 64, 96, bias=False)
    q = tl.quantize_linear(lin)
    zeros = torch.zeros(3, 4, 64, dtype=torch.bfloat16)
    assert torch.equal(q(zeros), torch.zeros(3, 4, 96, dtype=torch.bfloat16))
    a = torch.randint(-127, 128, (40, 64), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(0))
    whole = tl.int8_matmul(a, q.w_q)
    for m in (1, 5, 16, 17):
        assert torch.equal(tl.int8_matmul(a[:m], q.w_q), whole[:m]), m
    assert torch.equal(whole, (a.long() @ q.w_q.long().T).int())


@pytest.fixture(scope="module")
def vit_pair():
    jcfg = jvit.ViTConfig(**VIT)
    params = jvit.vit_init(jax.random.PRNGKey(0), jcfg)
    model = tvit.VisionTransformer(tvit.ViTConfig(**VIT))
    sd = {k: v.float() for k, v in vit_state_dict(jax.tree.map(np.array, params)).items()}
    model.load_state_dict(sd, strict=True)
    return jcfg, params, model.eval()


_VIT_LINEARS = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def test_quantize_vit_matches_quantize_vit_params(vit_pair):
    _, params, model = vit_pair
    ref = jvit.quantize_vit_params(params)
    q = tvit.quantize_vit(model)
    assert all(p.dtype == torch.float32 for p in model.parameters())  # the model is kept
    for blk, jblk in zip(q.blocks, ref["blocks"]):
        for jname, tname in _VIT_LINEARS.items():
            lin = blk.get_submodule(tname)
            assert isinstance(lin, tl.W8A8Linear)
            np.testing.assert_array_equal(lin.w_q.numpy(), np.asarray(jblk[jname]["w_q"]).T)
            np.testing.assert_array_equal(lin.s_w.numpy(), np.asarray(jblk[jname]["s_w"]))
            np.testing.assert_array_equal(lin.b.numpy(), np.asarray(jblk[jname]["b"]))
        for norm in ("norm1", "norm2"):
            assert blk.get_submodule(norm).weight.dtype == torch.bfloat16
            np.testing.assert_array_equal(blk.get_submodule(norm).weight.float().numpy(),
                                          np.asarray(jblk[norm]["g"], np.float32))
    for name, p in q.named_parameters():
        assert p.dtype == torch.bfloat16 and not p.requires_grad, name
    np.testing.assert_array_equal(q.pos_embed.float().numpy(),
                                  np.asarray(ref["pos_embed"], np.float32))
    assert ref["pos_embed"].dtype == jnp.bfloat16


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("feat_type", ["feat", "KK"])
def test_int8_backbone_features_match_jax(vit_pair, feat_type):
    """``backbone_features(..., "int8")``: float32 out, within bf16 rounding
    of JAX's, and cosine > 0.99 to the float32 features."""
    jcfg, params, model = vit_pair
    jf = jfeat.FeaturizerConfig(vit_config=jcfg, feat_type=feat_type)
    tf = tfeat.FeaturizerConfig(vit_config=tvit.ViTConfig(**VIT), feat_type=feat_type)
    net = tfeat.DinoFeaturizer(tf)
    net.model = model
    x = np.random.default_rng(0).standard_normal((2, 3, 64, 64)).astype(np.float32)
    ref, ref32 = jax.jit(lambda p, im: (
        jfeat.backbone_features(p, im, jf, backbone_dtype="int8")[0],
        jfeat.backbone_features(p, im, jf, precision="float32")[0]))({"vit": params},
                                                                     jnp.asarray(x))
    out, _ = tfeat.backbone_features(net, torch.from_numpy(x), backbone_dtype="int8")
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-2, atol=3e-2)
    assert _cos(out.numpy(), ref32) > 0.99
    assert _cos(out.numpy(), ref) > 0.9999


def test_int8_copy_is_derived_once_per_set_of_weights(vit_pair):
    """The copy is kept while the weights stay, derived again after an
    in-place update (an optimizer step, a load) or a replaced tensor."""
    _, _, model = vit_pair
    model = tvit.VisionTransformer(model.cfg).eval()
    model.load_state_dict(vit_pair[2].state_dict())
    first = tvit.int8_copy(model)
    assert tvit.int8_copy(model) is first
    w = model.blocks[1].mlp.fc2.weight
    with torch.no_grad():
        w.mul_(2.0)
    second = tvit.int8_copy(model)
    assert second is not first
    np.testing.assert_array_equal(second.blocks[1].mlp.fc2.s_w.numpy(),
                                  2 * first.blocks[1].mlp.fc2.s_w.numpy())
    assert tvit.int8_copy(model) is second
    model.blocks[0].attn.qkv.weight = torch.nn.Parameter(w.new_zeros(384, 128))
    third = tvit.int8_copy(model)
    assert third is not second and int(third.blocks[0].attn.qkv.w_q.abs().sum()) == 0
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():  # a copy made under inference mode serves outside it
        model.load_state_dict(vit_pair[2].state_dict())
        inside = tvit.int8_copy(model)(x.bfloat16())[0][0]
    torch.testing.assert_close(tvit.int8_copy(model)(x.bfloat16())[0][0], inside,
                               rtol=0, atol=0)


# -- BEiT ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def beit_pair():
    from depthg_tpu.models.zoedepth import model as jmodel
    from test_torch_zoedepth import JCFG, port_config
    from depthg_tpu_torch.models.zoedepth import model as tmodel
    from depthg_tpu_torch.models.zoedepth.convert import zoe_state_dict_from_params

    params = jax.tree.map(lambda a: np.array(a, np.float32),
                          jmodel.zoedepth_init(jax.random.PRNGKey(0), JCFG))
    model = tmodel.ZoeDepth(port_config(JCFG))
    model.load_state_dict(zoe_state_dict_from_params(params), strict=True)
    return JCFG, params, model.eval()


def test_quantize_beit_matches_quantize_beit_params(beit_pair):
    from depthg_tpu.models.zoedepth.beit import quantize_beit_params
    from depthg_tpu_torch.models.zoedepth.beit import quantize_beit

    _, params, model = beit_pair
    ref = quantize_beit_params(params["beit"])
    q = quantize_beit(model.core.core.pretrained.model)
    for blk, jblk in zip(q.blocks, ref["blocks"]):
        assert blk.attn.q_bias is None and blk.attn.v_bias is None
        for jname, lin in (("qkv", blk.attn.qkv), ("proj", blk.attn.proj),
                           ("fc1", blk.mlp.fc1), ("fc2", blk.mlp.fc2)):
            np.testing.assert_array_equal(lin.w_q.numpy(), np.asarray(jblk[jname]["w_q"]).T)
            np.testing.assert_array_equal(lin.s_w.numpy(), np.asarray(jblk[jname]["s_w"]))
            np.testing.assert_array_equal(lin.b.numpy(), np.asarray(jblk[jname]["b"]))
        for name, t in (("gamma_1", blk.gamma_1), ("rel_pos_table",
                                                   blk.attn.relative_position_bias_table)):
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(jblk[name], np.float32))
    assert all(p.dtype == torch.bfloat16 for p in q.parameters())
    assert model.core.core.pretrained.model.blocks[0].attn.q_bias is not None


def test_int8_beit_taps_match_jax(beit_pair):
    """Every tap of the int8 BEiT (eager attention with the resized bias)
    within 2e-2 of its largest value of JAX's, cosine > 0.99 to float32."""
    from depthg_tpu.models.zoedepth import beit as jbeit
    from depthg_tpu_torch.models.zoedepth.beit import quantize_beit

    jcfg, params, model = beit_pair
    x = (np.random.default_rng(0).random((2, 3, 64, 96)).astype(np.float32) - 0.5) / 0.5
    ref, ref32 = jax.jit(lambda p, im: (
        jbeit.beit_forward(jbeit.quantize_beit_params(p), im.astype(jnp.bfloat16), jcfg.beit)[0],
        jbeit.beit_forward(p, im, jcfg.beit)[0]))(params["beit"], jnp.asarray(x))
    grid = (4, 6)
    with torch.no_grad():
        taps, tgrid = quantize_beit(model.core.core.pretrained.model)(
            torch.from_numpy(x).bfloat16(), attn_impl="xla")
    assert tgrid == grid and len(taps) == 4
    for got, want, want32 in zip(taps, ref, ref32):
        assert got.dtype == torch.bfloat16
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
        assert _cos(got, want32) > 0.99


# -- the train step ----------------------------------------------------------------

def test_int8_train_step_matches_jax_over_three_steps():
    from test_torch_train_step import (JF, LOG_NAMES, LOSS, SH, W, _batch, _pair,
                                       _perms_from_key, _to_torch_layout, _torch_batch)
    from depthg_tpu.train import losses as jloss
    from depthg_tpu.train import step as jstep
    from depthg_tpu_torch.train import losses as tloss
    from depthg_tpu_torch.train import step as tstep

    jhp, thp, jstate, tstate = _pair({"backbone_dtype": "int8"})
    assert jhp.backbone_dtype == thp.backbone_dtype == "int8"
    jl, tlc = jloss.CorrLossConfig(**LOSS), tloss.CorrLossConfig(**LOSS)
    step = jax.jit(lambda s, b, k: (
        jstep.train_step(s, b, k, JF, jhp, jl, W, SH),
        jax.grad(lambda tr: jstep.loss_fn(tr, s["frozen"], b, k, JF, jhp, jl, W, SH)[0])(
            s["params"])))
    vit_before = {k: v.clone() for k, v in tstate.model.net.model.state_dict().items()}
    for i in range(3):
        batch = _batch(i)
        key = jax.random.PRNGKey(100 + i)
        (jstate, ref_logs), ref_grads = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                             key)
        logs = tstep.train_step(tstate, _torch_batch(batch), thp, tlc, W, SH,
                                neg_perms=_perms_from_key(key, 2, 8))
        for name in LOG_NAMES:
            np.testing.assert_allclose(float(logs[name]), float(ref_logs[name]),
                                       rtol=2e-2, atol=1e-5, err_msg=f"step {i} {name}")
        if i == 0:
            ref_grads = _to_torch_layout(jstate, ref_grads)
            grads = dict(tstate.model.named_parameters())
            for name, ref in ref_grads.items():
                if name.startswith("decoder."):
                    continue
                assert float((grads[name].grad - ref).norm()) <= 5e-2 * float(ref.norm()), name
    ref_params = _to_torch_layout(jstate, jstate["params"])
    out = tstep.eval_state_dict(tstate)
    for name, ref in ref_params.items():
        assert float((out[name] - ref).norm()) <= 5e-3 * float(ref.norm()), name
    for k, v in tstate.model.net.model.state_dict().items():  # the frozen ViT untouched
        assert torch.equal(v, vit_before[k]), k


def test_int8_zoedepth_depth_maps_match_jax(beit_pair):
    """``generate_depth``'s int8 model (``to_dtype(model, "int8")``: the
    BEiT quantized from float32, the rest bf16) against the JAX script's
    (``quantize_beit_params``, ``cast_tree_bf16`` of the rest) through
    ``zoedepth_infer`` with the flip TTA: the metric depth within 5e-3 of
    its largest value (one bf16 step is 3.9e-3; measured 9.2e-4). The 8-bit
    PNGs are not compared: with random weights a map spreads over 1.7e-3 of
    its level, so the CLI's per-image min-max turns bf16 roundings into
    whole 8-bit steps."""
    import copy

    from depthg_tpu.models.layers import cast_tree_bf16
    from depthg_tpu.models.zoedepth import beit as jbeit
    from depthg_tpu.models.zoedepth import model as jmodel
    from depthg_tpu_torch import generate_depth
    from depthg_tpu_torch.models.zoedepth import model as tmodel

    jcfg, params, model = beit_pair
    qparams = {k: (jbeit.quantize_beit_params(v) if k == "beit" else cast_tree_bf16(v))
               for k, v in params.items()}
    x = np.random.default_rng(1).random((2, 3, 64, 96)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, im: jmodel.zoedepth_infer(
        p, im.astype(jnp.bfloat16), jcfg).astype(jnp.float32))(qparams, jnp.asarray(x)))
    net = generate_depth.to_dtype(copy.deepcopy(model), "int8").eval()
    with torch.no_grad():
        got = tmodel.zoedepth_infer(net, torch.from_numpy(x).bfloat16()).float().numpy()
    assert got.shape == ref.shape == (2, 1, 64, 96)
    assert np.abs(got - ref).max() <= 5e-3 * np.abs(ref).max()


def test_backbone_dtype_study_runs_every_arm():
    """``backbone_dtype_study`` on the CPU with a 32-wide ViT: one seed of
    each arm (float32, bfloat16, int8) for two steps, each arm's eval
    forward on the same weights; ``make_dataset`` is the JAX script's."""
    import importlib.util
    import inspect
    import os

    from depthg_tpu_torch import backbone_dtype_study as study

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "depthg_scripts_backbone_dtype_study",
        os.path.join(root, "scripts", "backbone_dtype_study.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert inspect.getsource(study.make_dataset) == inspect.getsource(ref.make_dataset)
    fcfg = tfeat.FeaturizerConfig(dim=8, vit_config=tvit.ViTConfig(
        embed_dim=32, depth=1, num_heads=2, img_size=96))
    out = study.main(["--seeds", "1", "--steps", "2", "--chunk", "1", "--batch", "2",
                      "--res", "96", "--n-train", "8", "--n-val", "8",
                      "--arms", "bfloat16,int8", "--device", "cpu"], fcfg=fcfg)
    assert [r["dtype"] for r in out["rows"]] == ["float32", "bfloat16", "int8"]
    for r in out["eval_rows"]:
        for arm in ("bfloat16", "int8"):
            assert 0.0 <= r[f"{arm}_lin_agree"] <= 1.0 and np.isfinite(r[f"{arm}_linear"])
    assert all(np.isfinite(r["final_loss"]) for r in out["rows"])
    assert "| int8 | 0 | bfloat16 |" in out["report"]
