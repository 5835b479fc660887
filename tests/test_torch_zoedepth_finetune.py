"""ZoeDepth fine-tuning of the PyTorch port vs the JAX package, on the CPU.

Same seeded numpy inputs through ``depthg_tpu/models/zoedepth/finetune.py``
(and ``scripts/finetune_zoedepth.py``'s ``validate``) and through the
port's ``models/zoedepth/finetune.py`` / ``finetune_zoedepth.py``. Float32
on both sides, JAX at "highest" matmul precision; weights drawn by the JAX
package and carried over with ``zoe_state_dict_from_params``.

Tolerances, each with what was measured on an x86 host:
- the losses and ``compute_scale_and_shift``: 1e-5 relative; the losses'
  gradients with respect to the prediction: 1e-5 relative in norm, but SSI's
  1e-4 (``GRAD_VS_JAX``: JAX's own float32 gradient is 3e-5 off float64
  there), and every one within 1e-5 of the port's float64 gradient;
- the learning-rate groups: equal for every parameter;
- the schedule against ``optax.cosine_onecycle_schedule`` at every count of
  a 20-step run: 1e-7 of the group's peak (optax evaluates in float32, so
  its own rounding is ~6e-8 of a value; measured <= 9.7e-8);
- three steps of the JAX test's ``TINY`` model: each logged loss 2e-5
  relative (measured 2e-7), the step-1 gradients 1e-5 of the largest entry
  of their tensor (measured 4.0e-6: float32 sums in two orders through a
  network whose LayerScale is 1e-5), the parameters after three AdamW steps
  1e-5 absolute (measured 2.5e-6; Adam's update is +-lr whatever a
  gradient's size, so a rounding-sized gradient moves by up to lr);
- ``validate``'s metrics and SILog on three images: 1e-4 relative.
"""

import copy
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depthg_tpu.models.zoedepth import finetune as jft
from depthg_tpu.models.zoedepth.model import zoedepth_init
from depthg_tpu_torch.models import frozen_cache
from depthg_tpu_torch.models.zoedepth import beit as tbeit
from depthg_tpu_torch.models.zoedepth import finetune as tft
from depthg_tpu_torch.models.zoedepth import model as tmodel
from depthg_tpu_torch.models.zoedepth.convert import load_zoedepth_pt, zoe_state_dict_from_params
from test_torch_zoedepth import port_config
from test_zoedepth_data import _make_layout
from test_zoedepth_finetune import TINY

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _depth_batch(b=2, h=24, w=32, hole_frac=0.3, seed=0):
    """Positive predictions and targets; invalid target pixels hold the zero
    sentinel of real sparse depth maps."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.1, 9.0, (b, 1, h, w)).astype(np.float32)
    target = rng.uniform(0.1, 9.0, (b, 1, h, w)).astype(np.float32)
    mask = rng.random((b, 1, h, w)) > hole_frac
    return pred, np.where(mask, target, 0.0).astype(np.float32), mask


LOSSES = {"silog": (jft.silog_loss, tft.silog_loss),
          "grad_l1": (jft.grad_l1_loss, tft.grad_l1_loss),
          "ssi": (jft.scale_shift_invariant_loss, tft.scale_shift_invariant_loss)}


# gradient limits against JAX (relative error ||g - ref|| / ||ref||). SSI's
# gradient goes through the 2x2 normal equations, whose float32 sums XLA
# and torch take in different orders: JAX's own float32 gradient is 1.6e-5
# to 3e-5 off the float64 one there, the port's 3.3e-6 to 4.3e-6. So SSI is
# held to JAX at 1e-4 and, like every loss, to float64 at 1e-5.
GRAD_VS_JAX = {"silog": 1e-5, "grad_l1": 1e-5, "ssi": 1e-4}


@pytest.mark.parametrize("name", sorted(LOSSES))
@pytest.mark.parametrize("case", ["holes", "half_holes", "low_res_pred"])
def test_losses_and_gradients_match_jax(name, case):
    """Value and gradient with respect to the prediction (finite where the
    target holds zero sentinels); ``low_res_pred``: the prediction at half
    the target's size, resized with align_corners=True inside."""
    pred, target, mask = _depth_batch(hole_frac=0.5 if case == "half_holes" else 0.3,
                                      seed=sorted(LOSSES).index(name))
    if case == "low_res_pred":
        pred = pred[..., ::2, ::2].copy()
    jfn, tfn = LOSSES[name]
    with jax.default_matmul_precision("highest"):
        ref, ref_grad = jax.value_and_grad(jfn)(jnp.asarray(pred), jnp.asarray(target),
                                                jnp.asarray(mask))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        p = torch.from_numpy(pred).to(dtype).requires_grad_(True)
        out = tfn(p, torch.from_numpy(target).to(dtype), torch.from_numpy(mask))
        out.backward()
        grads[dtype] = p.grad.numpy().astype(np.float64)
        np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-5)
    grad, exact = grads[torch.float32], grads[torch.float64]
    assert np.isfinite(grad).all()
    ref_grad = np.asarray(ref_grad, np.float64)
    assert np.linalg.norm(grad - ref_grad) <= GRAD_VS_JAX[name] * np.linalg.norm(ref_grad)
    assert np.linalg.norm(grad - exact) <= 1e-5 * np.linalg.norm(exact)


@pytest.mark.parametrize("singular", [False, True])
def test_compute_scale_and_shift_matches_jax(singular):
    """Per-image (s, t) of a target that is 2.5 x pred + 0.7 plus noise; an
    all-masked image is singular: (0, 0), no NaN. The shift comes out of the
    normal equations' cancellation (in float32 JAX's is up to 9e-5 off the
    float64 solution, the port's 1.2e-5), so its error is taken relative to
    the largest value of the fitted line, |s| max(pred) + |t|; the scale's
    relative to itself. Both float32 and float64 within 1e-5 so of JAX's."""
    pred, _, mask = (a[:, 0] for a in _depth_batch(b=3, seed=5))
    noise = np.random.default_rng(6).standard_normal(pred.shape).astype(np.float32)
    target = (2.5 * pred + 0.7 + 0.3 * noise).astype(np.float32)
    if singular:
        mask[1] = False
    s_ref, t_ref = jft.compute_scale_and_shift(jnp.asarray(pred), jnp.asarray(target),
                                               jnp.asarray(mask))
    for dtype in (torch.float32, torch.float64):
        s, t = tft.compute_scale_and_shift(torch.from_numpy(pred).to(dtype),
                                           torch.from_numpy(target).to(dtype),
                                           torch.from_numpy(mask))
        line = np.abs(np.asarray(s_ref)) * pred.max(axis=(1, 2)) + np.abs(np.asarray(t_ref))
        np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5, atol=0)
        assert np.all(np.abs(t.numpy() - np.asarray(t_ref)) <= 1e-5 * line)
    if singular:
        assert float(s[1]) == 0.0 and float(t[1]) == 0.0


def _id_tree(tree):
    """Each leaf of the JAX parameter tree filled with its own leaf number."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(a), i, np.float32) for i, a in enumerate(leaves)]), leaves


def test_lr_groups_match_jax_for_every_parameter():
    """Each parameter of the port falls in the group the JAX package's
    ``lr_group_labels`` gives its leaf, found through the converter's key
    map (every leaf filled with its own number): the reassembly layers
    (``act_postprocess*``, beside the encoder) are ``midas``, the
    relative-position tables ``pos_enc``."""
    params = jax.eval_shape(lambda: zoedepth_init(jax.random.PRNGKey(0), TINY))
    ids, _ = _id_tree(params)
    labels = jax.tree_util.tree_leaves(jft.lr_group_labels(params))
    sd = zoe_state_dict_from_params(ids)
    model = tmodel.ZoeDepth(port_config(TINY))
    got = tft.lr_group_labels(model)
    assert set(got) == set(sd) and set(got.values()) == set(tft.GROUPS)
    for name, tensor in sd.items():
        leaf = int(tensor.flatten()[0])
        assert torch.all(tensor == leaf), name
        assert got[name] == labels[leaf], name
    assert got["core.core.pretrained.act_postprocess1.0.project.0.weight"] == "midas"
    assert got["core.core.pretrained.model.blocks.0.attn.relative_position_bias_table"] == "pos_enc"
    groups = tft.init_state(model, tft.FinetuneConfig()).optimizer.param_groups
    assert [g["name"] for g in groups] == list(tft.GROUPS)
    assert sum(len(g["params"]) for g in groups) == len(list(model.parameters()))


@pytest.mark.parametrize("factor", [1.0, 10.0])
def test_schedule_matches_optax(factor):
    """The four groups' one-cycle schedules at every count of a 20-step
    run and past its end."""
    cfg = tft.FinetuneConfig(total_steps=20)
    peak = cfg.lr / factor
    ref = optax.cosine_onecycle_schedule(20, peak, cfg.pct_start, cfg.div_factor,
                                         cfg.final_div_factor)
    ours = tft.cosine_onecycle_schedule(20, peak, cfg.pct_start, cfg.div_factor,
                                        cfg.final_div_factor)
    for count in range(23):
        assert abs(ours(count) - float(ref(count))) <= 1e-7 * peak, count
    with pytest.raises(ValueError, match="empty phase"):
        tft.cosine_onecycle_schedule(1, peak, 0.7)


@pytest.mark.parametrize("max_norm", [0.1, 1e3])
def test_clip_matches_optax(max_norm):
    """Global-norm clipping, triggered (0.1) and not (1e3)."""
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((4, 5), (7,), (2, 3, 3))]
    ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    ours = [torch.from_numpy(g.copy()) for g in grads]
    norm = tft.clip_by_global_norm_(ours, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def _pair(seed=1):
    params = jax.tree.map(lambda a: np.array(a, np.float32),
                          zoedepth_init(jax.random.PRNGKey(seed), TINY))
    model = tmodel.ZoeDepth(port_config(TINY))
    model.load_state_dict(zoe_state_dict_from_params(params), strict=True)
    return params, model


def test_finetune_steps_match_jax():
    """Three steps of ``make_finetune_step`` against ``finetune_step`` from
    the same weights on one batch with holes: losses, the step-1 gradients
    (before the clip) and the parameters after the third step."""
    params, model = _pair()
    rng = np.random.default_rng(0)
    img = rng.random((2, 3, 64, 96)).astype(np.float32)
    depth = rng.uniform(0.5, 8.0, (2, 1, 64, 96)).astype(np.float32)
    mask = rng.random((2, 1, 64, 96)) > 0.2
    depth = np.where(mask, depth, 0.0).astype(np.float32)
    jcfg, tcfg = jft.FinetuneConfig(total_steps=5), tft.FinetuneConfig(total_steps=5)
    batch = {"image": img, "depth": depth, "mask": mask}
    with jax.default_matmul_precision("highest"):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        _, ref_grads = jax.jit(jax.value_and_grad(jft.finetune_loss, has_aux=True),
                               static_argnums=(2, 3))(params, jb, TINY, jcfg)
        init_fn, step_fn = jft.make_finetune_step(TINY, jcfg)
        jp, opt_state = params, init_fn(params)
        ref_logs = []
        for _ in range(3):
            jp, opt_state, logs = step_fn(jp, opt_state, jb)
            ref_logs.append({k: float(v) for k, v in logs.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    probe = copy.deepcopy(model)
    loss, _ = tft.finetune_loss(probe, tb, tcfg)
    loss.backward()
    ref_grads = zoe_state_dict_from_params(jax.tree.map(lambda a: np.array(a, np.float32),
                                                        ref_grads))
    for name, p in probe.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad  # an unused decoder unit
        ref = ref_grads[name]
        scale = max(float(ref.abs().max()), 1e-30)
        assert float((grad - ref).abs().max()) <= 1e-5 * scale, name

    state = tft.init_state(model, tcfg)
    for ref in ref_logs:
        logs = tft.finetune_step(state, tb)
        assert sorted(logs) == sorted(ref) == ["loss/silog", "loss/total"]
        for k in ref:
            np.testing.assert_allclose(float(logs[k]), ref[k], rtol=2e-5, err_msg=k)
    assert state.step == 3
    ref_params = zoe_state_dict_from_params(jax.tree.map(lambda a: np.array(a, np.float32), jp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("clip", [0.1, 0.0])
def test_optimizer_matches_jax_on_hand_made_gradients(clip):
    """``apply_gradients`` against the JAX package's ``make_finetune_optimizer``
    over four steps of the ``TINY`` model's parameters, each step with new
    seeded gradients whose size changes by 10x from step to step, at a
    weight decay of 2 and a peak learning rate of 0.05 on a 4-step cycle:
    the decay moves a parameter by 10% of itself per step at the head's
    learning rate and the moments' betas set each update's direction and
    size, so a port without the decay or with other betas is off by percents
    (with the clip each step's gradients are first scaled to norm 0.1).
    Each entry's change over the four steps is held to JAX's within 1e-5 of
    its group's learning rates summed over the steps (an AdamW step moves an
    entry by about its learning rate; float32 sums of the moments differ by
    roundings of the gradients, which cancel where the moment is small) plus
    eight float32 roundings of the entry (2^-23 of its size each: torch
    rounds it twice per step, optax once; measured up to 4 near 1).
    """
    params, model = _pair(seed=3)
    kw = dict(lr=0.05, wd=2.0, clip_grad=clip, total_steps=4, pct_start=0.5)
    jcfg, tcfg = jft.FinetuneConfig(**kw), tft.FinetuneConfig(**kw)
    tx = jft.make_finetune_optimizer(params, jcfg)
    opt_state = tx.init(params)
    jp = params
    state = tft.init_state(model, tcfg)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    rng = np.random.default_rng(4)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    for step in range(4):
        scale = 10.0 ** (step % 2)
        grads = jax.tree_util.tree_unflatten(
            treedef, [(scale * rng.standard_normal(np.shape(a))).astype(np.float32)
                      for a in leaves])
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        sd = zoe_state_dict_from_params(grads)
        for name, p in model.named_parameters():
            p.grad = sd[name].clone()
        tft.apply_gradients(state)
    assert state.step == 4
    ref = zoe_state_dict_from_params(jax.tree.map(lambda a: np.array(a, np.float32), jp))
    groups = tft.lr_group_labels(model)
    for name, p in model.named_parameters():
        ref_change = (ref[name] - before[name]).double()
        change = (p.detach() - before[name]).double()
        lr_sum = sum(state.schedules[groups[name]](t) for t in range(4))
        assert float(ref_change.abs().max()) > 0, name
        tol = 1e-5 * lr_sum + 8 * 2.0**-23 * torch.maximum(before[name].abs(), p.detach().abs())
        assert bool(((change - ref_change).abs() <= tol.double()).all()), name


def _jax_script():
    """``scripts/finetune_zoedepth.py`` as a module (its ``validate``)."""
    spec = importlib.util.spec_from_file_location(
        "jax_finetune_zoedepth", os.path.join(ROOT, "scripts", "finetune_zoedepth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(tmp_path, n=3):
    from depthg_tpu_torch.models.zoedepth.data_mono import (DataLoadPreprocess,
                                                            MonoDepthDataConfig)

    root = str(tmp_path)
    fn = _make_layout(root, n=n, hw=(64, 96))
    dcfg = MonoDepthDataConfig(dataset="nyu", data_path=root, gt_path=root,
                               data_path_eval=root, gt_path_eval=root,
                               filenames_file=fn, filenames_file_eval=fn)
    return root, fn, dcfg, DataLoadPreprocess(dcfg, "online_eval")


def test_validate_matches_jax(tmp_path):
    """The nine metrics and SILog of ``validate`` over three images."""
    from depthg_tpu_torch import finetune_zoedepth as tcli
    from depthg_tpu_torch.models.zoedepth.config import DEPTH_DATASETS

    params, model = _pair(seed=2)
    _, _, dcfg, test_set = _data(tmp_path)
    spec = DEPTH_DATASETS["nyu"]
    with jax.default_matmul_precision("highest"):
        ref, ref_losses = _jax_script().validate(params, TINY, dcfg, test_set, spec)
    got, losses = tcli.validate(model, dcfg, test_set, spec)
    assert sorted(got) == sorted(ref) and len(got) == 9
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(losses["silog"], ref_losses["silog"], rtol=1e-4)


def test_finetune_cli_smoke(tmp_path, monkeypatch):
    """The port's twin of the JAX script's CLI smoke: the tiny model, 5
    steps over 3 epochs of 2 batches, validation; ``latest.pt`` and
    ``best.pt`` load through ``load_zoedepth_pt``, and the last one gives the
    depth of the model the run ended with."""
    from depthg_tpu_torch import finetune_zoedepth as tcli

    root, fn, dcfg, test_set = _data(tmp_path, n=4)
    out_dir = tmp_path / "out"
    seen = {}
    init_state = tft.init_state

    def keep(model, ftcfg):
        seen["state"] = init_state(model, ftcfg)
        return seen["state"]

    monkeypatch.setattr(tft, "init_state", keep)
    out = tcli.main([f"data_path={root}", f"gt_path={root}", f"data_path_eval={root}",
                     f"gt_path_eval={root}", f"filenames_file={fn}", f"filenames_file_eval={fn}",
                     "tiny_model=true", "batch_size=2", "epochs=3", "max_steps=5", "aug=false",
                     "random_crop=false", "eval_limit=2", "log_every=1",
                     f"output_dir={out_dir}", "device=cpu"])
    assert out["step"] == 5 and seen["state"].step == 5
    assert "abs_rel" in out["final"] and np.isfinite(out["last_logs"]["loss/total"])
    with open(out["log_path"]) as f:
        lines = [json.loads(ln) for ln in f]
    steps = [r for r in lines if "loss/total" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(r["loss/total"]) and r["ms"] > 0 for r in steps)
    assert sum("val" in r for r in lines) == 5 and "final" in lines[-1]
    blob = torch.load(out_dir / "latest.pt", weights_only=False)
    assert blob["step"] == 5 and set(blob) == {"model", "cfg", "step", "metrics"}
    best = torch.load(out_dir / "best.pt", weights_only=False)
    assert best["metrics"]["abs_rel"] == min(r["val"]["abs_rel"] for r in lines if "val" in r)
    x = torch.from_numpy(test_set[0]["image"][None])
    with torch.no_grad():
        ref = seen["state"].model(x)["metric_depth"]
        for name in ("latest.pt", "best.pt"):
            depth = load_zoedepth_pt(str(out_dir / name))(x)["metric_depth"]
            assert torch.isfinite(depth).all()
            if name == "latest.pt":
                torch.testing.assert_close(depth, ref, rtol=0, atol=0)


@pytest.mark.parametrize("path", ["weights.npz", "orbax_dir"])
def test_native_checkpoint_refused(tmp_path, path, monkeypatch):
    """What the reader of the JAX package's ZoeDepth trees refuses: a
    ``.npz`` that holds no ZoeDepth tree, and an orbax directory when
    tensorstore cannot be imported (it names the package). Reading both
    formats is in ``tests/test_torch_checkpoint_io.py``."""
    import sys

    from depthg_tpu_torch import finetune_zoedepth as tcli

    target = tmp_path / path
    if path == "orbax_dir":
        target.mkdir()
        monkeypatch.setitem(sys.modules, "tensorstore", None)
        error, match = NotImplementedError, "tensorstore"
    else:
        np.savez(target, **{"head.w": np.zeros(3, np.float32)})
        error, match = KeyError, "beit"
    with pytest.raises(error, match=match):
        tcli.build_model(dict(tcli.DEFAULTS, checkpoint=str(target)), torch.device("cpu"))


def test_bias_cache_keeps_one_entry_per_size_across_updates():
    """Two in-place updates of the table between no-grad forwards (an
    optimizer step between validations) leave the biases of the newest
    table alone: an update drops every older one, and each size is built
    again when it is next asked for."""
    model = tmodel.ZoeDepth(port_config(TINY)).init_weights(torch.Generator().manual_seed(0))
    attn = model.core.core.pretrained.model.blocks[0].attn
    table = attn.relative_position_bias_table

    def kept():  # (size, the table's version it was built from) of each kept bias
        return sorted((tag[1:], key[0][1]) for tag, (key, _) in
                      frozen_cache._ENTRIES[table].items())

    x64, x32 = torch.rand(1, 3, 64, 96), torch.rand(1, 3, 32, 64)
    with torch.no_grad():
        model(x64)
        model(x32)
        assert len(kept()) == 2
        for _ in range(2):
            table.add_(0.5)
            model(x64)
            assert [size for size, _ in kept()] == [(4, 6)]
        model(x32)
        version = table._version
        assert kept() == [((2, 4), version), ((4, 6), version)]
        fresh = attn.rel_pos_bias(4, 6)
    torch.testing.assert_close(fresh, tbeit.relative_position_bias(
        attn.relative_position_bias_table.detach(), 4, 4, 6, "bicubic"), rtol=0, atol=0)
