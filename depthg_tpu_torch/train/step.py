"""The DepthG training step (``depthg_tpu/train/step.py``).

* The frozen ViT runs under ``torch.no_grad()``; its parameters have
  ``requires_grad=False`` and enter no optimizer.
* Three ``torch.optim.Adam`` (net head [+ decoder when ``rec_weight > 0``]
  at ``lr``, linear probe and cluster probe at ``probe_lr``). The probe
  losses read ``code.detach()``, so one ``backward()`` over the total
  reproduces the reference's three-optimizer isolation.
* Decayed scalars (depth weight and shift) and the schedule's
  ``feature_samples`` / sampling mode (``train.decay``) are plain arguments:
  nothing is compiled, so a new value is just a new shape.
* Every random draw comes from the one ``torch.Generator`` the caller
  passes, on the batch's device.
* The featurizer is any of ``models.featurizer.dispatch_apply``'s: the
  DINO one, the depth-fused ``dino_depth`` (its depth pyramid,
  cross-attention and ``no_depth_embed`` train in the net group) or the
  ``feature-pyramid`` (its head trains; the head's BatchNorm takes one
  running-stat update per train-mode forward: img, img_pos, img_aug).
* ``lhp=True`` adds the LHP head (``models.lhp``): built from the
  generator, frozen, in no optimizer (``TrainState.lhp``); its code feeds a
  second correlation loss. The "attn" strategy runs the first forward's
  backbone eagerly for its attention maps.

* Data-parallel under a process group (``parallel.dist``): each rank runs
  its rows of the global batch, the losses are the single-process ones
  (``train.losses``; the masked cross-entropy divides by the global count
  of valid pixels; the pyramid's BatchNorm takes the global batch's
  statistics), and one all-reduce of a flat buffer averages every
  gradient before the three Adam steps, so every rank keeps the same
  weights. The logs are all-reduced. The draws' overrides are global.

``backbone_dtype`` is float32, bfloat16 or int8 (the ViT's w8a8 copy,
``models/vit.int8_copy``); the pyramid takes the first two only.
"""

from __future__ import annotations

import dataclasses

import torch

from depthg_tpu_torch.inference import Segmenter
from depthg_tpu_torch.models import featurizer as featurizer_lib
from depthg_tpu_torch.models import probes
from depthg_tpu_torch.models.lhp import LHP, LHPConfig, lhp_apply
from depthg_tpu_torch.models.pyramid import PyramidConfig
from depthg_tpu_torch.ops.correlation import norm, one_hot_feats
from depthg_tpu_torch.ops.resize import resize_bilinear
from depthg_tpu_torch.ops.sampling import sample
from depthg_tpu_torch.parallel import dist
from depthg_tpu_torch.train import losses as loss_lib
from depthg_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    """Static hyperparameters of the training objective."""
    n_classes: int
    pos_inter_weight: float = 0.25
    pos_intra_weight: float = 0.67
    neg_inter_weight: float = 0.63
    correspondence_weight: float = 1.0
    rec_weight: float = 0.0
    aug_alignment_weight: float = 0.0
    crf_weight: float = 0.0
    lr: float = 5e-4
    probe_lr: float = 5e-3
    use_depth: bool = True
    use_true_labels: bool = False
    use_depth_only_intra: bool = False
    extra_clusters: int = 0
    # LHP (reference src/train_segmentation.py:202-344); the LHP head is in
    # no optimizer in the reference and stays at its init here too
    lhp: bool = False
    lhp_weight: float = 0.2
    lhp_depth_weight: float = 1.0
    lhp_weight_balance: bool = False
    lhp_original_experiment: bool = False  # experiment_name contains "lhp_original"
    lhp_propagation_strategy: str = "depth"
    # "float32" forces the eager attention path (parity runs); None lets
    # "auto" take the Hopper kernel on CUDA
    precision: str | None = None
    # run the img / img_pos featurizer forwards as one stacked [2B] pass:
    # the same per-sample math, one dropout stream instead of two. Off by
    # default as in the JAX package; which is faster on a given card is a
    # measurement (``profile_train --fused_pair_forward``).
    fused_pair_forward: bool = False
    # frozen-backbone compute dtype. The config default
    # (``hparams_from_cfg``) is bfloat16; the dataclass default stays
    # float32 so parity harnesses keep reference numerics.
    backbone_dtype: str = "float32"
    # return the raw correlation tensors in the logs (TensorBoard histograms)
    log_hist: bool = False
    # ContrastiveCRFLoss constants (crf_weight > 0)
    crf_samples: int = 1000
    alpha: float = 0.5
    beta: float = 0.15
    gamma: float = 0.05
    w1: float = 10.0
    w2: float = 3.0
    shift: float = 0.0


def hparams_from_cfg(cfg, n_classes: int) -> TrainHParams:
    return TrainHParams(
        n_classes=n_classes,
        pos_inter_weight=float(cfg.pos_inter_weight),
        pos_intra_weight=float(cfg.pos_intra_weight),
        neg_inter_weight=float(cfg.neg_inter_weight),
        correspondence_weight=float(cfg.correspondence_weight),
        rec_weight=float(cfg.rec_weight),
        aug_alignment_weight=float(cfg.aug_alignment_weight),
        crf_weight=float(cfg.crf_weight),
        lr=float(cfg.lr),
        use_depth=bool(cfg.use_depth),
        use_true_labels=bool(cfg.use_true_labels),
        use_depth_only_intra=bool(cfg.get("use_depth_only_intra", False)),
        extra_clusters=int(cfg.extra_clusters),
        lhp=bool(cfg.get("lhp", False)),
        lhp_weight=float(cfg.get("lhp_weight", 0.2)),
        lhp_depth_weight=float(cfg.get("lhp_depth_weight", 1.0)),
        lhp_weight_balance=bool(cfg.get("lhp_weight_balance", False)),
        lhp_original_experiment="lhp_original" in str(cfg.get("experiment_name", "")),
        lhp_propagation_strategy=str(cfg.get("propagation_strategy", "depth")),
        precision=cfg.get("matmul_precision"),
        backbone_dtype=str(cfg.get("backbone_dtype", "bfloat16")),
        fused_pair_forward=bool(cfg.get("fused_pair_forward", False)),
        crf_samples=int(cfg.crf_samples),
        alpha=float(cfg.alpha), beta=float(cfg.beta), gamma=float(cfg.gamma),
        w1=float(cfg.w1), w2=float(cfg.w2), shift=float(cfg.shift),
    )


def check_supported(hp: TrainHParams) -> None:
    if hp.backbone_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"unknown backbone_dtype {hp.backbone_dtype!r}")


@dataclasses.dataclass
class TrainState:
    """The segmenter (with its decoder), the three optimizers
    (``net`` / ``linear`` / ``cluster``), the step counter and, with
    ``lhp=True``, the frozen LHP head."""
    model: Segmenter
    opt: dict
    step: int = 0
    lhp: LHP | None = None


def _net_group(model: Segmenter, hp: TrainHParams) -> list:
    """The parameters of the net optimizer: the featurizer's trainable
    parameters (all but the frozen backbone ``model``), and the decoder only
    when the reconstruction loss is on."""
    params = [p for name, p in model.net.named_parameters()
              if not name.startswith("model.")]
    if hp.rec_weight > 0:
        params += list(model.decoder.parameters())
    return params


def make_optimizers(model: Segmenter, hp: TrainHParams) -> dict:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 added to sqrt(v))."""
    return {
        "net": torch.optim.Adam(_net_group(model, hp), lr=hp.lr),
        "linear": torch.optim.Adam(model.linear_probe.parameters(), lr=hp.probe_lr),
        "cluster": torch.optim.Adam(model.cluster_probe.parameters(), lr=hp.probe_lr),
    }


def state_from_model(model: Segmenter, hp: TrainHParams,
                     generator: torch.Generator | None = None,
                     lhp_state_dict: dict | None = None) -> TrainState:
    """Freeze the backbone of ``model`` (built with ``decoder=True``) and
    give it fresh optimizers. With ``hp.lhp`` the LHP head takes
    ``lhp_state_dict`` (``proj.fc{1,2}.*``) or, without one, weights drawn
    from ``generator`` (a CPU generator)."""
    check_supported(hp)
    model.net.model.requires_grad_(False)
    lhp = None
    if hp.lhp:
        lhp = LHP(LHPConfig(dim=model.net.fcfg.dim,
                            propagation_strategy=hp.lhp_propagation_strategy,
                            original=hp.lhp_original_experiment))
        if lhp_state_dict is not None:
            lhp.load_state_dict(lhp_state_dict, strict=True)
        elif generator is None:
            raise ValueError("lhp=True: pass the generator that draws the LHP head "
                             "or its lhp_state_dict")
        else:
            lhp.init_weights(generator)
        lhp = lhp.requires_grad_(False).to(model.linear_probe.weight.device)
    return TrainState(model=model, opt=make_optimizers(model, hp), step=0, lhp=lhp)


def init_state(fcfg, hp: TrainHParams, generator: torch.Generator, *,
               device: torch.device | str) -> TrainState:
    """A random-weight train state from ``generator`` (a CPU generator: the
    weights, and then the LHP head's, are drawn on the host and moved to
    ``device``, which the caller names). ``fcfg`` is any featurizer config."""
    model = Segmenter(fcfg, hp.n_classes, hp.n_classes + hp.extra_clusters,
                      decoder=True).init_weights(generator).to(device)
    return state_from_model(model, hp, generator)


def cross_entropy_masked(logits: torch.Tensor, labels: torch.Tensor, n_classes: int,
                         class_axis: int = -1) -> torch.Tensor:
    """``CrossEntropyLoss`` over the pixels whose label lies in
    [0, n_classes): labels outside are masked (not indexed), and a batch
    without a valid pixel gives 0, not NaN. ``class_axis=1`` takes NCHW
    logits, ``-1`` channel-last ones."""
    logits = logits.float()
    if class_axis in (-1, logits.dim() - 1):
        logits = logits.movedim(-1, 1)
    elif class_axis != 1:
        raise ValueError(f"class_axis must be 1 or -1, got {class_axis}")
    mask = (labels >= 0) & (labels < n_classes)
    safe = labels.clamp(0, n_classes - 1).long()
    lse = torch.logsumexp(logits, dim=1)
    picked = logits.gather(1, safe[:, None])[:, 0]
    nll = torch.where(mask, lse - picked, torch.zeros_like(lse))
    if dist.active():
        # the global mean: this rank's sum over the global count, times the
        # world, so that the mean over ranks is the single-process loss
        return nll.sum() * dist.world() / dist.all_reduce_sum(mask.sum()).clamp_min(1)
    return nll.sum() / mask.sum().clamp_min(1)


def loss_fn(model: Segmenter, batch: dict, hp: TrainHParams,
            lcfg: loss_lib.CorrLossConfig, depth_feat_weight: float,
            depth_feat_shift: float, generator: torch.Generator | None = None,
            coords_override=None, neg_perms=None, lhp: LHP | None = None,
            lhp_coords_override=None, lhp_neg_perms=None):
    """Total loss and logs. ``batch``: img, img_pos, label, depth,
    depth_pos ([B, 1, H, W]) and, by option, label_pos, mask, mask_pos,
    img_aug, coord_aug, all on one device. ``coords_override`` and
    ``neg_perms`` fix the correlation loss's draws, ``lhp_coords_override``
    and ``lhp_neg_perms`` those of the LHP loss; ``lhp`` is the frozen LHP
    head (``hp.lhp``)."""
    check_supported(hp)
    if hp.lhp and lhp is None:
        raise ValueError("lhp=True needs the LHP head (TrainState.lhp)")
    net = model.net
    img, label = batch["img"], batch["label"]
    depth, depth_pos = batch.get("depth"), batch.get("depth_pos")
    bdt = None if hp.backbone_dtype == "float32" else hp.backbone_dtype
    # only LHP's "attn" strategy reads attention maps, and only the first
    # forward's: every other forward may take the attention kernel
    need_attn = hp.lhp and hp.lhp_propagation_strategy == "attn"

    def featurize(x, d=None, attn=False):
        return featurizer_lib.dispatch_apply(
            net, x, d, precision=hp.precision, backbone_dtype=bdt, train=True,
            generator=generator, need_attn=attn)

    # the stacked pass is not taken where it would change the result: the
    # attention maps of the first forward alone, the pyramid's BatchNorm
    # (batch statistics per forward), and depth on one side only
    fuse_pair = (hp.fused_pair_forward and hp.correspondence_weight > 0
                 and not need_attn and not isinstance(net.fcfg, PyramidConfig)
                 and (depth is None) == (depth_pos is None))
    out_pos = None
    if fuse_pair:
        b = img.shape[0]
        depth_both = None if depth is None else torch.cat([depth, depth_pos])
        with dist.row_blocks(2):
            both = featurize(torch.cat([img, batch["img_pos"]]), depth_both)
        out = {"feats": both["feats"][:b], "code": both["code"][:b], "attn": None}
        out_pos = {"feats": both["feats"][b:], "code": both["code"][b:]}
    else:
        out = featurize(img, depth, need_attn)
    feats, code = out["feats"], out["code"]

    logs: dict = {}
    loss = 0.0

    if hp.correspondence_weight > 0:
        if out_pos is None:
            out_pos = featurize(batch["img_pos"], depth_pos)
        feats_pos, code_pos = out_pos["feats"], out_pos["code"]

        if hp.use_true_labels:
            signal = one_hot_feats(label + 1, hp.n_classes + 1)
            signal_pos = one_hot_feats(batch["label_pos"] + 1, hp.n_classes + 1)
        else:
            signal, signal_pos = feats, feats_pos

        def corr_loss(c, c_pos, coords, perms):
            if hp.use_depth_only_intra:
                return loss_lib.depth_contrastive_correlation_loss(
                    lcfg, signal, signal_pos, c, c_pos,
                    depth_aug_feats=feats, depth_aug_feats_pos=feats_pos,
                    salience=batch.get("mask"), salience_pos=batch.get("mask_pos"),
                    coords_override=coords, neg_perms=perms, generator=generator)
            return loss_lib.contrastive_correlation_loss(
                lcfg, signal, signal_pos, c, c_pos,
                depth=depth, depth_pos=depth_pos,
                salience=batch.get("mask"), salience_pos=batch.get("mask_pos"),
                coords_override=coords, neg_perms=perms,
                depth_feat_shift=depth_feat_shift, generator=generator)

        corr = corr_loss(code, code_pos, coords_override, neg_perms)
        pos_intra = corr["pos_intra_loss"]
        pos_inter = corr["pos_inter_loss"]
        neg_inter = corr["neg_inter_loss"].mean()
        logs.update({
            "loss/pos_intra": pos_intra, "loss/pos_inter": pos_inter,
            "loss/neg_inter": neg_inter,
            "cd/pos_intra": corr["pos_intra_cd"].mean(),
            "cd/pos_inter": corr["pos_inter_cd"].mean(),
            "cd/neg_inter": corr["neg_inter_cd"].mean(),
        })
        if hp.log_hist:
            logs["hist/intra_cd"] = corr["pos_intra_cd"]
            logs["hist/inter_cd"] = corr["pos_inter_cd"]
            logs["hist/neg_cd"] = corr["neg_inter_cd"]
        corr_total = (hp.pos_inter_weight * pos_inter
                      + hp.pos_intra_weight * pos_intra
                      + hp.neg_inter_weight * neg_inter)
        has_df = lcfg.depth_feat_correlation_loss and not hp.use_depth_only_intra
        if has_df:
            logs["loss/depth_feat"] = corr["depth_feat_loss"]
            logs["cd/depth_feat"] = corr["depth_feat_cd"].mean()
            corr_total = corr_total + depth_feat_weight * corr["depth_feat_loss"]

        if hp.lhp:
            # the reference's balance and zeroing rules
            # (src/train_segmentation.py:325-344): the lhp_original zeroing
            # exists only inside its depth-feature branch
            balance = hp.lhp_weight if (has_df and hp.lhp_weight_balance) else 0.0
            lhp_weight = hp.lhp_weight
            main_scale = (hp.correspondence_weight - balance if has_df
                          else hp.correspondence_weight)
            if hp.lhp_original_experiment and has_df:
                main_scale, lhp_weight = 0.0, 1.0
            loss = loss + corr_total * main_scale

            # positive side: the projection alone (the reference passes no depth)
            lhp_corr = corr_loss(lhp_apply(lhp, code, depth, out["attn"]),
                                 lhp_apply(lhp, code_pos), lhp_coords_override, lhp_neg_perms)
            lhp_total = (hp.pos_inter_weight * lhp_corr["pos_inter_loss"]
                         + hp.pos_intra_weight * lhp_corr["pos_intra_loss"]
                         + hp.neg_inter_weight * lhp_corr["neg_inter_loss"].mean())
            if has_df:
                lhp_total = lhp_total + (depth_feat_weight * hp.lhp_depth_weight
                                         * lhp_corr["depth_feat_loss"])
            loss = loss + lhp_total * lhp_weight
            logs["loss/lhp_pos_intra"] = lhp_corr["pos_intra_loss"]
            logs["loss/lhp_pos_inter"] = lhp_corr["pos_inter_loss"]
        else:
            loss = loss + corr_total * hp.correspondence_weight

    if hp.rec_weight > 0:
        rec_feats = model.decoder(code)
        rec_loss = -(norm(rec_feats) * norm(feats)).sum(1).mean()
        logs["loss/rec"] = rec_loss
        loss = loss + hp.rec_weight * rec_loss

    if hp.aug_alignment_weight > 0:
        code_aug = featurize(batch["img_aug"])["code"]
        down = resize_bilinear(batch["coord_aug"].permute(0, 3, 1, 2),
                               code_aug.shape[2]).permute(0, 2, 3, 1)
        aug_alignment = -(norm(sample(code, down)) * norm(code_aug)).sum(1).mean()
        logs["loss/aug_alignment"] = aug_alignment
        loss = loss + hp.aug_alignment_weight * aug_alignment

    if hp.crf_weight > 0:
        crf = loss_lib.contrastive_crf_loss(
            resize_bilinear(img, 56), norm(resize_bilinear(code, 56)),
            hp.crf_samples, hp.alpha, hp.beta, hp.gamma, hp.w1, hp.w2, hp.shift,
            generator=generator).mean()
        logs["loss/crf"] = crf
        loss = loss + hp.crf_weight * crf

    detached_code = code.detach()

    linear_logits = probes.linear_probe_apply(model.linear_probe, detached_code)
    linear_logits = resize_bilinear(linear_logits, label.shape[-2:])
    linear_loss = cross_entropy_masked(linear_logits, label, hp.n_classes, class_axis=1)
    logs["loss/linear"] = linear_loss
    loss = loss + linear_loss

    cluster_loss, _ = probes.cluster_lookup_apply(
        model.cluster_probe.clusters, detached_code, None, log_probs=False)
    logs["loss/cluster"] = cluster_loss
    loss = loss + cluster_loss
    logs["loss/total"] = loss
    return loss, logs


def train_step(state: TrainState, batch: dict, hp: TrainHParams,
               lcfg: loss_lib.CorrLossConfig, depth_feat_weight: float,
               depth_feat_shift: float, generator: torch.Generator | None = None,
               coords_override=None, neg_perms=None, lhp_coords_override=None,
               lhp_neg_perms=None) -> dict:
    """One optimization step in place: one backward over the total loss, then
    the three optimizer steps. Returns the logs as detached tensors on the
    batch's device (nothing here waits for the device). Spans
    (``utils.profiling``): ``train.step`` holds ``optimizer`` (the
    ``zero_grad``s), ``train.forward`` (``loss_fn``), ``backward`` and
    ``optimizer`` again (the gradients' average and the Adam steps)."""
    with profiling.span("train.step"):
        with profiling.span("optimizer"):
            for opt in state.opt.values():
                opt.zero_grad(set_to_none=True)
        with profiling.span("train.forward"):
            loss, logs = loss_fn(state.model, batch, hp, lcfg, depth_feat_weight,
                                 depth_feat_shift, generator, coords_override, neg_perms,
                                 state.lhp, lhp_coords_override, lhp_neg_perms)
        with profiling.span("backward"):
            loss.backward()
        with profiling.span("optimizer"):
            dist.average_gradients([p for opt in state.opt.values()
                                    for group in opt.param_groups for p in group["params"]])
            for opt in state.opt.values():
                opt.step()
        state.step += 1
        return _global_logs({k: v.detach() for k, v in logs.items()})


def _global_logs(logs: dict) -> dict:
    """Under a process group: each scalar log the mean over ranks (one
    all-reduce), each histogram the rows of every rank."""
    if not dist.active():
        return logs
    names = [k for k, v in logs.items() if v.dim() == 0]
    if names:
        means = dist.mean(torch.stack([logs[k].float() for k in names]))
        logs.update(zip(names, means.unbind()))
    for k, v in logs.items():
        if v.dim() > 0:
            logs[k] = dist.all_gather(v)
    return logs


def eval_state_dict(state: TrainState) -> dict:
    """The segmenter's full state dict in the reference Lightning layout
    (``net.model.*``, ``net.cluster*``, ``linear_probe.*``,
    ``cluster_probe.clusters``, ``decoder.*``), detached."""
    return {k: v.detach() for k, v in state.model.state_dict().items()}


def reset_probes(state: TrainState, generator: torch.Generator,
                 hp: TrainHParams) -> TrainState:
    """The reference's ``reset_probe_steps`` behaviour: re-draw both probes
    (from ``generator``, on the host) and give them fresh optimizers. The
    net head, the decoder and the net optimizer are untouched."""
    model = state.model
    device = model.linear_probe.weight.device
    fresh_linear = probes.conv1x1_init_(torch.nn.Conv2d(
        model.linear_probe.in_channels, model.linear_probe.out_channels, 1), generator)
    fresh_cluster = probes.cluster_lookup_init_(probes.ClusterLookup(
        model.cluster_probe.clusters.shape[1], model.cluster_probe.clusters.shape[0]),
        generator)
    with torch.no_grad():
        model.linear_probe.weight.copy_(fresh_linear.weight.to(device))
        model.linear_probe.bias.copy_(fresh_linear.bias.to(device))
        model.cluster_probe.clusters.copy_(fresh_cluster.clusters.to(device))
    fresh = make_optimizers(model, hp)
    state.opt["linear"], state.opt["cluster"] = fresh["linear"], fresh["cluster"]
    return state
