"""The train step of the PyTorch port vs the JAX package, on the CPU.

The tiny ViT of ``tests/test_train_step.py`` (2 blocks, 32 wide, 32 px),
weights carried through ``state_dict_from_jax(keep_decoder=True)``, one
seeded numpy batch, ``drop_rate=0``, FPS sampling (which draws nothing) and
the negatives' permutations re-derived from the JAX key exactly as
``loss_fn`` derives them, so no random stream has to match.

Measured on an x86 host (float32 on both sides): every logged loss within
3.7e-6 relative over three steps, the step-1 gradients within 6.3e-7 of the
largest entry of their tensor, the parameters after three Adam steps within
1.8e-7 absolute. The tests hold 2e-5 relative, 1e-5 of the largest entry
and 1e-5 absolute (Adam divides by sqrt(v): an update is +-lr whatever the
gradient's size, so the parameters get room for a rounding-sized difference
in a small gradient).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.models import featurizer as jfeat
from depthg_tpu.models.vit import ViTConfig as JViTConfig
from depthg_tpu.ops.sampling import super_perm as jsuper_perm
from depthg_tpu.train import decay as jdecay
from depthg_tpu.train import losses as jloss
from depthg_tpu.train import step as jstep
from depthg_tpu_torch import inference as tinf
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.models.vit import ViTConfig as TViTConfig
from depthg_tpu_torch.train import decay as tdecay
from depthg_tpu_torch.train import losses as tloss
from depthg_tpu_torch.train import step as tstep
from depthg_tpu_torch.utils.ckpt import state_dict_from_jax

torch.set_num_threads(1)

VIT = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)
JF = jfeat.FeaturizerConfig(arch="vit_small", patch_size=8, dim=16, vit_config=JViTConfig(**VIT),
                            dropout=False, drop_rate=0.0)
TF = tfeat.FeaturizerConfig(arch="vit_small", patch_size=8, dim=16, vit_config=TViTConfig(**VIT),
                            dropout=False, drop_rate=0.0)
LOSS = dict(feature_samples=3, neg_samples=2, depth_sampling="fps",
            depth_feat_correlation_loss=True)
W, SH = 0.19, 0.03
LOG_NAMES = ("loss/total", "loss/pos_intra", "loss/pos_inter", "loss/neg_inter",
             "loss/depth_feat", "loss/linear", "loss/cluster", "cd/pos_intra",
             "cd/pos_inter", "cd/neg_inter", "cd/depth_feat")


def _batch(seed, b=8):
    rng = np.random.default_rng(seed)
    return {
        "img": rng.standard_normal((b, 3, 32, 32)).astype(np.float32),
        "img_pos": rng.standard_normal((b, 3, 32, 32)).astype(np.float32),
        "label": rng.integers(-1, 3, size=(b, 32, 32)),
        "depth": rng.random((b, 1, 32, 32)).astype(np.float32),
        "depth_pos": rng.random((b, 1, 32, 32)).astype(np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _perms_from_key(key, neg, b):
    """The negatives' permutations as ``jstep.loss_fn`` derives them: the
    third of six sub-keys goes to the correlation loss, whose second half
    splits into one key per negative."""
    k3 = jax.random.split(key, 6)[2]
    _, kn = jax.random.split(k3)
    return torch.from_numpy(np.stack(
        [np.asarray(jsuper_perm(k, b)) for k in jax.random.split(kn, neg)]).astype(np.int64))


def _to_torch_layout(state, tree):
    """A JAX trainable tree (parameters or gradients) in the port's keys."""
    full = {"net": dict(tree["net"], vit=state["frozen"]["vit"]),
            **{k: v for k, v in tree.items() if k != "net"}}
    sd = state_dict_from_jax(full, keep_decoder=True)
    return {k: v for k, v in sd.items() if not k.startswith("net.model.")}


def _pair(hp_kw=None, seed=0):
    hp_kw = dict(n_classes=3, lr=1e-3, **(hp_kw or {}))
    jhp, thp = jstep.TrainHParams(**hp_kw), tstep.TrainHParams(**hp_kw)
    jstate = jstep.init_state(jax.random.PRNGKey(seed), JF, jhp)
    sd = state_dict_from_jax(jstep.eval_params_from_state(jstate), keep_decoder=True)
    tstate = tstep.state_from_model(tinf.Segmenter.from_state_dict(sd, TF), thp)
    return jhp, thp, jstate, tstate


def test_train_step_matches_jax_over_three_steps():
    jhp, thp, jstate, tstate = _pair()
    jl, tl = jloss.CorrLossConfig(**LOSS), tloss.CorrLossConfig(**LOSS)
    # one program for the step and the gradients it applies (one compile)
    step = jax.jit(lambda s, b, k: (
        jstep.train_step(s, b, k, JF, jhp, jl, W, SH),
        jax.grad(lambda tr: jstep.loss_fn(tr, s["frozen"], b, k, JF, jhp, jl, W, SH)[0])(
            s["params"])))
    for i in range(3):
        batch = _batch(i)
        key = jax.random.PRNGKey(100 + i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (jstate, ref_logs), ref_grads = step(jstate, jb, key)
        ref_grads = _to_torch_layout(jstate, ref_grads)
        logs = tstep.train_step(tstate, _torch_batch(batch), thp, tl, W, SH,
                                neg_perms=_perms_from_key(key, 2, 8))
        assert sorted(logs) == sorted(ref_logs) == sorted(LOG_NAMES)
        for name in LOG_NAMES:
            np.testing.assert_allclose(float(logs[name]), float(ref_logs[name]),
                                       rtol=2e-5, atol=1e-7, err_msg=f"step {i} {name}")
        if i == 0:
            grads = {k: p.grad for k, p in tstate.model.named_parameters()}
            for name, ref in ref_grads.items():
                if name.startswith("decoder."):  # rec_weight == 0: no gradient at all
                    assert grads[name] is None and float(ref.abs().max()) == 0.0
                    continue
                scale = max(float(ref.abs().max()), 1e-12)
                assert float((grads[name] - ref).abs().max()) <= 1e-5 * scale, name
    assert tstate.step == int(jstate["step"]) == 3
    ref_params = _to_torch_layout(jstate, jstate["params"])
    out = tstep.eval_state_dict(tstate)
    for name, ref in ref_params.items():
        np.testing.assert_allclose(out[name].numpy(), ref.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    for name, p in tstate.model.named_parameters():
        if name.startswith("net.model."):
            assert not p.requires_grad and p.grad is None


@pytest.mark.parametrize("hp_kw,batch_extra", [
    ({"rec_weight": 0.3}, None),
    ({"crf_weight": 0.0, "use_true_labels": True}, "label_pos"),
    ({"use_depth_only_intra": True}, None),
    ({"fused_pair_forward": True}, None),
    ({"correspondence_weight": 0.0}, None),
], ids=["rec", "true_labels", "depth_only_intra", "fused_pair", "probes_only"])
def test_loss_fn_options_match_jax(hp_kw, batch_extra):
    """The options of the objective that are plain tensor code, each against
    the JAX ``loss_fn`` with fixed coordinates where the option draws them."""
    jhp, thp, jstate, tstate = _pair(hp_kw, seed=1)
    jl, tl = jloss.CorrLossConfig(**LOSS), tloss.CorrLossConfig(**LOSS)
    batch = _batch(5)
    if batch_extra == "label_pos":
        batch["label_pos"] = np.random.default_rng(6).integers(-1, 3, size=(8, 32, 32))
    key = jax.random.PRNGKey(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    coords = None
    if hp_kw.get("use_depth_only_intra"):
        # this variant samples random coordinates: take the ones JAX drew
        k3 = jax.random.split(key, 6)[2]
        kc, _ = jax.random.split(k3)
        c1, c2 = jloss.select_coords(kc, dataclasses.replace(jl, depth_sampling="none"),
                                     jnp.zeros((8, 1, 4, 4)), jnp.zeros((8, 1, 4, 4)), None, None)
        coords = (torch.from_numpy(np.array(c1)), torch.from_numpy(np.array(c2)))
    _, ref_logs = jax.jit(lambda tr, fr, b, k: jstep.loss_fn(
        tr, fr, b, k, JF, jhp, jl, W, SH))(jstate["params"], jstate["frozen"], jb, key)
    _, logs = tstep.loss_fn(tstate.model, _torch_batch(batch), thp, tl, W, SH,
                            coords_override=coords, neg_perms=_perms_from_key(key, 2, 8))
    assert sorted(logs) == sorted(ref_logs)
    for name in logs:
        np.testing.assert_allclose(float(logs[name].detach()), float(ref_logs[name]),
                                   rtol=2e-5, atol=1e-7, err_msg=name)


def test_aug_alignment_and_crf_terms_run_and_reach_the_head():
    """The augmentation-alignment and CRF terms (their draws come from the
    generator): finite, logged, and with a gradient to the projection head."""
    _, thp, _, tstate = _pair({"aug_alignment_weight": 0.5, "crf_weight": 0.2,
                               "crf_samples": 50}, seed=2)
    batch = _batch(8)
    rng = np.random.default_rng(9)
    batch["img_aug"] = rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
    batch["coord_aug"] = rng.uniform(-1, 1, (8, 32, 32, 2)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    logs = tstep.train_step(tstate, _torch_batch(batch), thp, tloss.CorrLossConfig(**LOSS),
                            W, SH, generator=gen)
    for name in ("loss/aug_alignment", "loss/crf", "loss/total"):
        assert bool(torch.isfinite(logs[name])), name
    assert float(tstate.model.net.cluster1[0].weight.grad.abs().sum()) > 0


def test_log_hist_and_salience_options():
    """``log_hist`` returns the raw correlation tensors beside the scalars;
    ``use_salience`` draws its coordinates from the masks."""
    _, thp, _, tstate = _pair({"log_hist": True}, seed=5)
    batch = _torch_batch(_batch(15))
    rng = np.random.default_rng(16)
    batch["mask"] = torch.from_numpy((rng.random((8, 32, 32)) > 0.5).astype(np.float32))
    batch["mask_pos"] = torch.from_numpy((rng.random((8, 32, 32)) > 0.5).astype(np.float32))
    tl = tloss.CorrLossConfig(**dict(LOSS, use_salience=True))
    logs = tstep.train_step(tstate, batch, thp, tl, W, SH,
                            generator=torch.Generator().manual_seed(0))
    assert logs["hist/intra_cd"].shape == logs["hist/inter_cd"].shape == (8, 3, 3, 3, 3)
    assert logs["hist/neg_cd"].shape == (2, 8, 3, 3, 3, 3)
    assert all(bool(torch.isfinite(v).all()) for v in logs.values())


def test_group_isolation():
    """A probe loss moves no head parameter and the contrastive loss no probe
    parameter; the decoder joins the net optimizer only when rec_weight > 0."""
    _, thp, _, tstate = _pair(seed=3)
    tl = tloss.CorrLossConfig(**LOSS)
    model = tstate.model
    batch = _torch_batch(_batch(10))
    perms = _perms_from_key(jax.random.PRNGKey(0), 2, 8)
    _, logs = tstep.loss_fn(model, batch, thp, tl, W, SH, neg_perms=perms)
    head = [p for n, p in model.named_parameters() if n.startswith("net.cluster")]
    probes = [model.linear_probe.weight, model.linear_probe.bias, model.cluster_probe.clusters]
    probe_loss = logs["loss/linear"] + logs["loss/cluster"]
    for g in torch.autograd.grad(probe_loss, head, allow_unused=True, retain_graph=True):
        assert g is None
    corr = logs["loss/total"] - probe_loss
    for g in torch.autograd.grad(corr, probes, allow_unused=True, retain_graph=True):
        assert g is None or not bool(g.any())  # total - probe terms: exactly 0
    for g in torch.autograd.grad(corr, head, retain_graph=True):
        assert float(g.abs().sum()) > 0
    for g in torch.autograd.grad(probe_loss, probes):
        assert float(g.abs().sum()) > 0

    def ids(opt):
        return {id(p) for group in opt.param_groups for p in group["params"]}

    assert ids(tstate.opt["net"]) == {id(p) for p in head}
    assert ids(tstate.opt["linear"]) == {id(p) for p in probes[:2]}
    assert ids(tstate.opt["cluster"]) == {id(probes[2])}
    assert tstate.opt["net"].param_groups[0]["lr"] == 1e-3
    assert tstate.opt["linear"].param_groups[0]["lr"] == tstate.opt["cluster"].param_groups[0]["lr"] == 5e-3
    with_rec = tstep.make_optimizers(model, dataclasses.replace(thp, rec_weight=0.1))
    assert ids(with_rec["net"]) == {id(p) for p in head} | {id(p) for p in model.decoder.parameters()}
    vit = {id(p) for p in model.net.model.parameters()}
    assert not any(vit & ids(o) for o in list(tstate.opt.values()) + list(with_rec.values()))

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tstep.train_step(tstate, batch, thp, tl, W, SH, neg_perms=perms)
    for n, p in model.named_parameters():
        moved = not torch.equal(p, before[n])
        assert moved == (not n.startswith(("net.model.", "decoder."))), n


def test_reset_probes_changes_only_probes_and_their_optimizers():
    _, thp, _, tstate = _pair(seed=4)
    tl = tloss.CorrLossConfig(**LOSS)
    perms = _perms_from_key(jax.random.PRNGKey(0), 2, 8)
    tstep.train_step(tstate, _torch_batch(_batch(11)), thp, tl, W, SH, neg_perms=perms)
    before = {n: p.detach().clone() for n, p in tstate.model.named_parameters()}
    net_opt, net_moments = tstate.opt["net"], tstate.opt["net"].state_dict()["state"]
    old = (tstate.opt["linear"], tstate.opt["cluster"])
    assert len(old[0].state) == 2 and len(old[1].state) == 1
    out = tstep.reset_probes(tstate, torch.Generator().manual_seed(5), thp)
    assert out is tstate and tstate.step == 1
    for n, p in tstate.model.named_parameters():
        changed = not torch.equal(p, before[n])
        assert changed == n.startswith(("linear_probe.", "cluster_probe.")), n
    assert tstate.opt["net"] is net_opt and len(net_opt.state_dict()["state"]) == len(net_moments)
    assert tstate.opt["linear"] is not old[0] and tstate.opt["cluster"] is not old[1]
    assert len(tstate.opt["linear"].state) == 0 and len(tstate.opt["cluster"].state) == 0
    again = tstep.reset_probes(tstate, torch.Generator().manual_seed(5), thp)
    assert torch.equal(again.model.cluster_probe.clusters, out.model.cluster_probe.clusters)
    tstep.train_step(tstate, _torch_batch(_batch(12)), thp, tl, W, SH, neg_perms=perms)


@pytest.mark.parametrize("case", ["mixed", "all_masked", "channel_last"])
def test_cross_entropy_masked_matches_jax(case):
    """Labels below 0 or >= n_classes are masked and never indexed; an
    all-masked batch gives 0, not NaN."""
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((4, 27, 9, 11)).astype(np.float32)
    labels = rng.integers(-1, 29, size=(4, 9, 11))
    if case == "all_masked":
        labels = np.where(labels % 2 == 0, -1, 27)
    axis = -1 if case == "channel_last" else 1
    if axis == -1:
        logits = np.ascontiguousarray(logits.transpose(0, 2, 3, 1))
    ref = jstep.cross_entropy_masked(jnp.asarray(logits), jnp.asarray(labels), 27, class_axis=axis)
    lg = torch.from_numpy(logits).requires_grad_(True)
    out = tstep.cross_entropy_masked(lg, torch.from_numpy(labels), 27, class_axis=axis)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6, atol=1e-7)
    out.backward()
    assert bool(torch.isfinite(lg.grad).all())
    if case == "all_masked":
        assert float(out) == 0.0 and float(lg.grad.abs().sum()) == 0.0
    with pytest.raises(ValueError):
        tstep.cross_entropy_masked(lg, torch.from_numpy(labels), 27, class_axis=2)


def test_hparams_from_cfg_match_jax_and_unported_options_raise():
    from depthg_tpu.config import load_config as jload
    from depthg_tpu_torch.config import load_config as tload

    over = ["lr=1e-3", "rec_weight=0.2", "extra_clusters=3", "matmul_precision=float32"]
    ref = jstep.hparams_from_cfg(jload("train_config.yml", over), 27)
    out = tstep.hparams_from_cfg(tload("train_config.yml", over), 27)
    for f in dataclasses.fields(out):
        assert getattr(out, f.name) == getattr(ref, f.name), f.name
    assert out.backbone_dtype == "bfloat16" and out.probe_lr == 5e-3
    assert tstep.hparams_from_cfg(tload("local_config.yml"), 27).backbone_dtype == "bfloat16"
    gen = torch.Generator().manual_seed(0)
    # ROADMAP item 8 is ported: an int8 backbone builds (its three steps
    # against JAX are in tests/test_torch_int8.py); an unknown dtype raises
    assert tstep.init_state(TF, tstep.TrainHParams(n_classes=3, backbone_dtype="int8"),
                            gen, device="cpu").step == 0
    with pytest.raises(ValueError, match="backbone_dtype"):
        tstep.init_state(TF, tstep.TrainHParams(n_classes=3, backbone_dtype="fp8"), gen,
                         device="cpu")
    # ROADMAP item 6 is ported: lhp=True builds its frozen head, and the
    # depth-fused and pyramid archs resolve to their config types
    from depthg_tpu.utils.checkpoint_io import fcfg_from_run_cfg as jfcfg
    from depthg_tpu_torch.models.featurizer_depth import DepthFeaturizerConfig
    from depthg_tpu_torch.models.lhp import LHP
    from depthg_tpu_torch.models.pyramid import PyramidConfig

    state = tstep.init_state(TF, tstep.TrainHParams(n_classes=3, lhp=True), gen, device="cpu")
    assert isinstance(state.lhp, LHP) and state.lhp.cfg.dim == TF.dim
    for arch, cls in (("dino_depth", DepthFeaturizerConfig), ("feature-pyramid", PyramidConfig)):
        flags = [f"arch={arch}", "guidance=sum", "granularity=3"]
        out = tinf.fcfg_from_run_cfg(tload("local_config.yml", flags))
        ref = jfcfg(jload("local_config.yml", flags))
        assert type(out) is cls and type(ref).__name__ == cls.__name__
        for f in dataclasses.fields(out):
            if f.name != "vit_config":
                assert getattr(out, f.name) == getattr(ref, f.name), (arch, f.name)


def test_init_state_is_seeded_and_learns_on_a_fixed_batch():
    """Random init from a generator; dropout on (masks from the generator);
    the probes' losses fall on a fixed batch."""
    fcfg = dataclasses.replace(TF, dropout=True, drop_rate=0.1)
    hp = tstep.TrainHParams(n_classes=3, lr=1e-3)
    a = tstep.init_state(fcfg, hp, torch.Generator().manual_seed(0), device="cpu")
    b = tstep.init_state(fcfg, hp, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
    assert "decoder.weight" in tstep.eval_state_dict(a)
    tl = tloss.CorrLossConfig(**LOSS)
    batch = _torch_batch(_batch(14))
    gen = torch.Generator().manual_seed(1)
    probe = []
    for _ in range(6):
        logs = tstep.train_step(a, batch, hp, tl, W, SH, generator=gen)
        assert all(bool(torch.isfinite(v).all()) for v in logs.values())
        probe.append(float(logs["loss/linear"] + logs["loss/cluster"]))
    assert probe[-1] < probe[0] and a.step == 6


@pytest.mark.parametrize("kw", [
    dict(depth_loss_decay=True, decay_every_steps=3, depth_loss_decay_factor=0.5,
         depth_feat_weight=0.19, depth_feat_shift=0.03),
    dict(depth_loss_decay=True, fix_depth_feat_shift=True, decay_every_steps=2,
         depth_loss_decay_factor=0.9, depth_feat_weight=0.1, depth_feat_shift=0.2),
    dict(fps_sample_decay=True, fps_sample_decay_every_steps=2, fps_sample_decay_factor=0.8,
         fps_min_samples=4),
    dict(fps_until_step=5, post_fps_samples=7, fps_sample_decay=True,
         fps_sample_decay_every_steps=3),
    dict(),
])
def test_decay_copy_held_exactly(kw):
    jd, td = jdecay.DecayConfig(**kw), tdecay.DecayConfig(**kw)
    assert dataclasses.asdict(jd) == dataclasses.asdict(td)
    for step in range(0, 14):
        assert tdecay.depth_feat_weight(td, step) == jdecay.depth_feat_weight(jd, step)
        assert tdecay.depth_feat_shift(td, step) == jdecay.depth_feat_shift(jd, step)
        assert tdecay.sampling_schedule(td, step) == jdecay.sampling_schedule(jd, step)
    for version, args in (("exp", (11, 0.9, 3, 4)), ("lin", (0.5, 0.1, 2, 0.05))):
        js, ts = jdecay.get_depth_scheduler(version)(*args), tdecay.get_depth_scheduler(version)(*args)
        assert [ts(s) for s in range(12)] == [js(s) for s in range(12)]
    with pytest.raises(NotImplementedError):
        tdecay.get_depth_scheduler("cos")


def test_decay_from_cfg_and_source_match_jax():
    """``from_cfg`` reads the same keys, and the copy's code is the
    original's (docstrings aside)."""
    import ast
    import inspect

    from depthg_tpu.config import load_config as jload
    from depthg_tpu_torch.config import load_config as tload

    over = ["depth_loss_decay=True", "fps_until_step=40", "depth_feat_weight=0.19"]
    assert dataclasses.asdict(tdecay.from_cfg(tload("local_config.yml", over))) == \
        dataclasses.asdict(jdecay.from_cfg(jload("local_config.yml", over)))

    def code(mod):
        tree = ast.parse(inspect.getsource(mod))
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                body.pop(0)
        return ast.dump(tree)

    assert code(tdecay) == code(jdecay)
