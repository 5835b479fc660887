"""The train step's variants in the PyTorch port vs the JAX package, on the
CPU: LHP ("depth" and "attn" propagation), the depth-fused featurizer
(``dino_depth``: cross_attn with its dropout at 0, sum, none) and the
feature pyramid.

Both sides start from one JAX ``init_state`` carried over by
``state_dict_from_jax`` (the LHP head, the depth featurizer's parts, the
pyramid's ResNet-50 and head with their BatchNorm statistics); dropout is
off, FPS sampling draws nothing, and the negatives' permutations of both
correlation losses are re-derived from the JAX key as ``loss_fn`` derives
them (the third of its six sub-keys for the main loss, the fourth for the
LHP loss), so no random stream has to match.

Tolerances: every logged loss 2e-5 relative at each of three steps; the
step-1 gradients 1e-5 of the largest entry of their tensor (for a
convolution's bias in front of a train-mode BatchNorm, whose gradient is
zero in exact arithmetic and rounding noise in both packages, of the same
convolution's weight); parameters and BatchNorm running statistics after
the first and the third step within 1e-5 of JAX's plus what Adam makes of
the two packages' gradient differences. Adam divides by |g| + eps (1e-8):
a gradient entry that cancels to rounding noise (the key third of the
cross-attention's in-projection bias, which softmax ignores, a bias in
front of BatchNorm, single entries) becomes an update of any size up to
lr, and a ReLU that flips on a 1e-7 parameter difference moves a later
gradient entry. ``_adam_gap`` runs Adam in float64 on each package's
gradients of every step and takes the difference of the two results as
that part; a BatchNorm running mean takes its conv bias's. For entries
whose gradients lie well above eps it is below 1e-7. The learning rate is
1e-4 (the ``arch=dino`` test's 1e-3 carries the pyramid's second BatchNorm
mean 3.5e-4 apart through the first convolution's noise entries, which its
bias's gap does not cover); parameters still move by up to 3e-4, 30 times
the tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.models import featurizer as jfeat
from depthg_tpu.models.featurizer_depth import DepthFeaturizerConfig as JDepthConfig
from depthg_tpu.models.pyramid import PyramidConfig as JPyramidConfig
from depthg_tpu.models.vit import ViTConfig as JViTConfig
from depthg_tpu.ops.sampling import super_perm as jsuper_perm
from depthg_tpu.train import losses as jloss
from depthg_tpu.train import step as jstep
from depthg_tpu_torch import inference as tinf
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.models.featurizer_depth import DepthFeaturizerConfig as TDepthConfig
from depthg_tpu_torch.models.pyramid import PyramidConfig as TPyramidConfig
from depthg_tpu_torch.models.vit import ViTConfig as TViTConfig
from depthg_tpu_torch.train import losses as tloss
from depthg_tpu_torch.train import step as tstep
from depthg_tpu_torch.utils.ckpt import state_dict_from_jax

torch.set_num_threads(1)

# the JAX tests' TINY_VIT: 384 wide so that the 3-stage depth pyramid lines
# up with the patch-8 grid
VIT = dict(patch_size=8, embed_dim=384, depth=1, num_heads=2, img_size=32)
BASE = dict(arch="vit_small", patch_size=8, dim=16, dropout=False, drop_rate=0.0)
LOSS = dict(feature_samples=3, neg_samples=2, depth_sampling="fps",
            depth_feat_correlation_loss=True)
W, SH = 0.19, 0.03
B = 4


def _configs(kind, guidance="cross_attn", granularity=2):
    if kind == "pyramid":
        kw = dict(granularity=granularity, dim=16, out_size=16)
        return JPyramidConfig(**kw), TPyramidConfig(**kw)
    if kind == "depth":
        kw = dict(BASE, guidance=guidance, cross_attn_heads=4, cross_attn_dropout=0.0)
        return (JDepthConfig(vit_config=JViTConfig(**VIT), **kw),
                TDepthConfig(vit_config=TViTConfig(**VIT), **kw))
    return (jfeat.FeaturizerConfig(vit_config=JViTConfig(**VIT), **BASE),
            tfeat.FeaturizerConfig(vit_config=TViTConfig(**VIT), **BASE))


def _batch(seed, res=32):
    rng = np.random.default_rng(seed)
    return {
        "img": rng.standard_normal((B, 3, res, res)).astype(np.float32),
        "img_pos": rng.standard_normal((B, 3, res, res)).astype(np.float32),
        "label": rng.integers(-1, 3, size=(B, res, res)),
        "depth": rng.random((B, 1, res, res)).astype(np.float32),
        "depth_pos": rng.random((B, 1, res, res)).astype(np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _perms_from_key(key, sub, neg=2, b=B):
    """The negatives' permutations of the correlation loss that takes
    sub-key ``sub`` of ``loss_fn``'s six (2: main, 3: LHP)."""
    k = jax.random.split(key, 6)[sub]
    _, kn = jax.random.split(k)
    return torch.from_numpy(np.stack(
        [np.asarray(jsuper_perm(kk, b)) for kk in jax.random.split(kn, neg)]).astype(np.int64))


def _to_torch_layout(state, tree):
    full = {"net": dict(tree["net"], vit=state["frozen"]["vit"]),
            **{k: v for k, v in tree.items() if k != "net"}}
    sd = state_dict_from_jax(full, keep_decoder=True)
    return {k: v for k, v in sd.items() if not k.startswith("net.model.")}


def pair(jf, tf, hp_kw, seed=0):
    """Both train states from one JAX ``init_state``."""
    hp_kw = dict(n_classes=3, lr=1e-4, **hp_kw)
    jhp, thp = jstep.TrainHParams(**hp_kw), tstep.TrainHParams(**hp_kw)
    jstate = jstep.init_state(jax.random.PRNGKey(seed), jf, jhp)
    sd = state_dict_from_jax(jstep.eval_params_from_state(jstate), keep_decoder=True)
    lhp_sd = {k[len("lhp."):]: sd.pop(k) for k in list(sd) if k.startswith("lhp.")}
    model = tinf.Segmenter.from_state_dict(sd, tf)
    tstate = tstep.state_from_model(model, thp, lhp_state_dict=lhp_sd or None)
    return jhp, thp, jstate, tstate


CASES = {
    "lhp_depth": ("vit", {}, dict(lhp=True)),
    "lhp_attn": ("vit", {}, dict(lhp=True, lhp_propagation_strategy="attn",
                                 lhp_weight_balance=True)),
    "dino_depth_cross_attn": ("depth", dict(guidance="cross_attn"), {}),
    "dino_depth_sum": ("depth", dict(guidance="sum"), {}),
    "dino_depth_none": ("depth", dict(guidance="none"), {}),
    "pyramid": ("pyramid", dict(granularity=2), {}),
}


def _grad_scale(grads, name):
    """The largest gradient entry of ``name``'s tensor or, for a conv bias
    in front of a BatchNorm (``net.convK.convJ.bias``), of its weight."""
    if name.startswith("net.conv") and name.endswith(".bias"):
        name = name[:-len(".bias")] + ".weight"
    return max(float(grads[name].abs().max()), 1e-12)


def _adam(grads, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The total float64 Adam update of a gradient sequence (optax's and
    torch's formula: eps added to the bias-corrected sqrt(v))."""
    m = v = total = 0
    for t, g in enumerate(grads, start=1):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        total = total - lr * (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
    return total


def _adam_gap(grad_seqs, name, lr):
    """How far Adam alone carries the two packages' parameter ``name`` apart
    through their gradient differences so far."""
    if name not in grad_seqs:
        return 0.0
    ref, port = grad_seqs[name]
    return (_adam(port, lr) - _adam(ref, lr)).abs().float()


def _hold_params(jstate, tstate, grad_seqs, lr):
    """Parameters and BatchNorm statistics vs JAX's: 1e-5 plus the Adam gap
    (a running mean takes its conv bias's)."""
    ref_params = _to_torch_layout(jstate, jstate["params"])
    out = tstep.eval_state_dict(tstate)
    for name, ref in ref_params.items():
        if name.endswith("num_batches_tracked"):
            continue
        source = name
        if name.endswith(".running_mean"):  # net.convK.bnJ -> net.convK.convJ.bias
            head, bn, _ = name.rsplit(".", 2)
            source = f"{head}.conv{bn[2:]}.bias"
        diff = (out[name] - ref).abs()
        bad = diff > 1e-5 + _adam_gap(grad_seqs, source, lr)
        assert not bool(bad.any()), (name, float(diff.max()), int(bad.sum()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_variant_train_step_matches_jax_over_three_steps(case):
    kind, cfg_kw, hp_kw = CASES[case]
    jf, tf = _configs(kind, **cfg_kw)
    jhp, thp, jstate, tstate = pair(jf, tf, hp_kw)
    jl, tl = jloss.CorrLossConfig(**LOSS), tloss.CorrLossConfig(**LOSS)
    step = jax.jit(lambda s, b, k: (
        jstep.train_step(s, b, k, jf, jhp, jl, W, SH),
        jax.grad(lambda tr: jstep.loss_fn(tr, s["frozen"], b, k, jf, jhp, jl, W, SH)[0])(
            s["params"])))
    lhp_before = ({k: v.clone() for k, v in tstate.lhp.state_dict().items()}
                  if tstate.lhp is not None else None)
    grad_seqs = {}  # name -> ([JAX gradient per step], [port gradient per step])
    for i in range(3):
        batch = _batch(i)
        key = jax.random.PRNGKey(100 + i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (jstate, ref_logs), ref_grads = step(jstate, jb, key)
        ref_logs = {k: v for k, v in ref_logs.items() if k != "aux/bn_stats"}
        ref_grads = _to_torch_layout(jstate, ref_grads)
        logs = tstep.train_step(tstate, _torch_batch(batch), thp, tl, W, SH,
                                neg_perms=_perms_from_key(key, 2),
                                lhp_neg_perms=_perms_from_key(key, 3))
        for name, p in tstate.model.named_parameters():
            if name in ref_grads and p.grad is not None:
                seqs = grad_seqs.setdefault(name, ([], []))
                seqs[0].append(ref_grads[name].double())
                seqs[1].append(p.grad.double())
        assert sorted(logs) == sorted(ref_logs)
        for name in ref_logs:
            np.testing.assert_allclose(float(logs[name]), float(ref_logs[name]),
                                       rtol=2e-5, atol=1e-7, err_msg=f"step {i} {name}")
        if i == 0:
            grads = {k: p.grad for k, p in tstate.model.named_parameters()}
            for name, ref in ref_grads.items():
                if name not in grads:  # BatchNorm statistics: buffers, no gradient
                    continue
                if grads[name] is None:  # unused: the decoder, no_depth_embed in train
                    assert float(ref.abs().max()) == 0.0, name
                    continue
                scale = _grad_scale(ref_grads, name)
                assert float((grads[name] - ref).abs().max()) <= 1e-5 * scale, name
        if i in (0, 2):
            _hold_params(jstate, tstate, grad_seqs, thp.lr)
    for name, p in tstate.model.named_parameters():
        if name.startswith("net.model."):
            assert not p.requires_grad and p.grad is None
    if lhp_before is not None:
        for k, v in tstate.lhp.state_dict().items():
            assert torch.equal(v, lhp_before[k]), k


@pytest.mark.parametrize("case", ["lhp_depth", "dino_depth_cross_attn", "dino_depth_sum",
                                  "pyramid"])
def test_segmenter_from_jax_init_state_gives_jax_code(case):
    """A port ``Segmenter`` built from a JAX ``init_state`` (through
    ``state_dict_from_jax``) gives the JAX featurizer's eval code: 1e-5
    relative."""
    kind, cfg_kw, hp_kw = CASES[case]
    jf, tf = _configs(kind, **cfg_kw)
    jhp, _, jstate, tstate = pair(jf, tf, hp_kw, seed=3)
    res = 64 if kind == "pyramid" else 32
    img = np.random.default_rng(4).standard_normal((2, 3, res, res)).astype(np.float32)
    ref = jfeat.dispatch_apply(jstep.eval_params_from_state(jstate)["net"], jnp.asarray(img),
                               jf, precision="float32")
    with torch.no_grad():
        out = tfeat.dispatch_apply(tstate.model.net, torch.from_numpy(img), precision="float32")
    np.testing.assert_allclose(out["code"].numpy(), np.asarray(ref["code"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["feats"].numpy(), np.asarray(ref["feats"]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["dino_depth_cross_attn", "dino_depth_sum", "pyramid"])
def test_variant_eval_and_validation_steps_match_jax(case):
    """``make_eval_step`` (flip TTA, probes, no CRF) and
    ``make_validation_step`` on a ``dino_depth`` net (eval: the no-depth
    embed) and a pyramid net (eval: running-stat BatchNorm): predictions of
    the JAX steps on >= 99.9% of pixels, confusion totals equal."""
    from depthg_tpu import inference as jinf

    kind, cfg_kw, hp_kw = CASES[case]
    jf, tf = _configs(kind, **cfg_kw)
    _, _, jstate, tstate = pair(jf, tf, hp_kw, seed=5)
    params = jstep.eval_params_from_state(jstate)
    res = 64 if kind == "pyramid" else 32
    rng = np.random.default_rng(6)
    img = rng.standard_normal((2, 3, res, res)).astype(np.float32)
    label = rng.integers(-1, 3, size=(2, res, res)).astype(np.int32)
    kw = dict(n_classes=3, label_res=res, run_crf=False, precision="float32")
    ref = jinf.make_predict_step(jf, jinf.EvalConfig(**kw))(params, jnp.asarray(img))
    out = tinf.make_predict_step(tinf.EvalConfig(**kw))(tstate.model, torch.from_numpy(img))
    for o, r in zip(out, ref):
        assert float((o.numpy() == np.asarray(r)).mean()) >= 0.999
    lin, clu = tinf.make_eval_step(tinf.EvalConfig(**kw))(
        tstate.model, torch.from_numpy(img), torch.from_numpy(label))
    counted = int(((label >= 0) & (label < 3)).sum())
    assert int(lin.sum()) == int(clu.sum()) == counted
    jl, jc = jinf.make_validation_step(jf, 3)(params, jnp.asarray(img), jnp.asarray(label), res)
    tl, tc = tinf.make_validation_step(3)(tstate.model, torch.from_numpy(img),
                                          torch.from_numpy(label), res)
    for o, r in ((tl, jl), (tc, jc)):
        assert int(o.sum()) == int(np.asarray(r).sum()) == counted
        assert float(np.abs(o.numpy() - np.asarray(r)).sum()) <= 0.002 * counted


@pytest.mark.parametrize("case,depth_pos,fused", [
    ("lhp_attn", True, False),       # the attention maps of the first forward alone
    ("pyramid", True, False),        # BatchNorm's batch statistics per forward
    ("dino_depth_sum", False, False),  # depth on one side only
    ("dino_depth_sum", True, True),
    ("lhp_depth", True, True),
])
def test_fused_pair_forward_only_where_it_keeps_the_result(monkeypatch, case, depth_pos,
                                                           fused):
    """``fused_pair_forward`` stacks img and img_pos into one forward only
    where that gives the same loss: it is not taken for LHP's attention
    propagation, for the pyramid and for one-sided depth, as in the JAX
    package. The loss is JAX ``loss_fn``'s with the same option."""
    kind, cfg_kw, hp_kw = CASES[case]
    jf, tf = _configs(kind, **cfg_kw)
    jhp, thp, jstate, tstate = pair(jf, tf, dict(hp_kw, fused_pair_forward=True), seed=7)
    batch = _batch(8)
    if not depth_pos:
        del batch["depth_pos"]
    key = jax.random.PRNGKey(9)
    jl, tl = jloss.CorrLossConfig(**LOSS), tloss.CorrLossConfig(**LOSS)
    if not depth_pos:
        jl, tl = (dataclasses.replace(c, depth_sampling="none", depth_feat_correlation_loss=False)
                  for c in (jl, tl))
    calls = []
    real = tfeat.dispatch_apply
    monkeypatch.setattr(tfeat, "dispatch_apply",
                        lambda net, img, *a, **k: calls.append(img.shape[0]) or real(
                            net, img, *a, **k))
    coords = None
    if not depth_pos:  # random coordinates: take the ones JAX drew
        kc, _ = jax.random.split(jax.random.split(key, 6)[2])
        c1, c2 = jloss.select_coords(kc, jl, jnp.zeros((B, 1, 4, 4)), jnp.zeros((B, 1, 4, 4)),
                                     None, None)
        coords = (torch.from_numpy(np.array(c1)), torch.from_numpy(np.array(c2)))
    _, ref = jax.jit(lambda tr, fr, b, k: jstep.loss_fn(tr, fr, b, k, jf, jhp, jl, W, SH))(
        jstate["params"], jstate["frozen"], {k: jnp.asarray(v) for k, v in batch.items()}, key)
    _, logs = tstep.loss_fn(tstate.model, _torch_batch(batch), thp, tl, W, SH,
                            coords_override=coords, neg_perms=_perms_from_key(key, 2),
                            lhp=tstate.lhp, lhp_coords_override=coords,
                            lhp_neg_perms=_perms_from_key(key, 3))
    assert calls == ([2 * B] if fused else [B, B])
    for name in ref:
        if name != "aux/bn_stats":
            np.testing.assert_allclose(float(logs[name].detach()), float(ref[name]),
                                       rtol=2e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_groups_and_frozen_parts(case):
    """The net Adam holds the featurizer's trainable parameters (the depth
    pyramid, cross-attention and ``no_depth_embed``; the pyramid head with
    its BatchNorm scales) and never the frozen backbone; the LHP head is in
    no optimizer and takes no gradient."""
    kind, cfg_kw, hp_kw = CASES[case]
    _, tf = _configs(kind, **cfg_kw)
    thp = tstep.TrainHParams(n_classes=3, **hp_kw)
    state = tstep.init_state(tf, thp, torch.Generator().manual_seed(0), device="cpu")
    net_ids = {id(p) for g in state.opt["net"].param_groups for p in g["params"]}
    all_ids = {id(p) for o in state.opt.values() for g in o.param_groups for p in g["params"]}
    for name, p in state.model.net.named_parameters():
        assert (id(p) in net_ids) == (not name.startswith("model.")), name
        assert p.requires_grad == (not name.startswith("model.")), name
    expected = {"depth": ("depth_downscaling.", "cross_attn.", "no_depth_embed"),
                "pyramid": ("conv2.bn1.", "cluster2.")}.get(kind, ())
    names = [n for n, _ in state.model.net.named_parameters()]
    for prefix in expected:
        assert any(n.startswith(prefix) for n in names), prefix
    assert (state.lhp is not None) == thp.lhp
    if state.lhp is not None:
        assert not any(id(p) in all_ids or p.requires_grad for p in state.lhp.parameters())
        again = tstep.init_state(tf, thp, torch.Generator().manual_seed(0), device="cpu")
        for a, b in zip(state.lhp.parameters(), again.lhp.parameters()):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="LHP head"):
            tstep.state_from_model(state.model, thp)
        with pytest.raises(ValueError, match="LHP head"):
            tstep.loss_fn(state.model, _torch_batch(_batch(0)), thp,
                          tloss.CorrLossConfig(**LOSS), W, SH)


@pytest.mark.parametrize("granularity", [1, 2, 3, 4])
@pytest.mark.parametrize("continuous", [True, False])
def test_pyramid_steps_at_every_granularity(granularity, continuous):
    """A random pyramid segmenter trains two steps at each granularity,
    both ways of ``continuous``: finite logs, the head and its BatchNorm
    statistics move, the ResNet does not."""
    tf = TPyramidConfig(granularity=granularity, dim=8, out_size=16, continuous=continuous)
    thp = tstep.TrainHParams(n_classes=3)
    state = tstep.init_state(tf, thp, torch.Generator().manual_seed(granularity), device="cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    gen = torch.Generator().manual_seed(1)
    for i in range(2):
        logs = tstep.train_step(state, _torch_batch(_batch(i, res=64)), thp,
                                tloss.CorrLossConfig(**LOSS), W, SH, generator=gen)
        assert all(bool(torch.isfinite(v).all()) for v in logs.values())
    after = state.model.state_dict()
    for k, v in after.items():
        moved = not torch.equal(v, before[k])
        if k.startswith("net.model."):
            assert not moved, k
        elif ".running_" in k or k.startswith("net.cluster"):
            assert moved, k


def test_hparams_from_cfg_read_the_lhp_keys_like_jax():
    from depthg_tpu.config import load_config as jload
    from depthg_tpu_torch.config import load_config as tload

    over = ["lhp=True", "lhp_weight=0.3", "lhp_depth_weight=0.5", "lhp_weight_balance=True",
            "propagation_strategy=attn", "experiment_name=x_lhp_original_y"]
    ref = jstep.hparams_from_cfg(jload("train_config.yml", over), 27)
    out = tstep.hparams_from_cfg(tload("train_config.yml", over), 27)
    for f in dataclasses.fields(out):
        assert getattr(out, f.name) == getattr(ref, f.name), f.name
    assert out.lhp and out.lhp_original_experiment and out.lhp_propagation_strategy == "attn"
