"""Eval/serve prediction path and the trainer's validation step
(``depthg_tpu/inference.py`` and the config functions of
``depthg_tpu/utils/checkpoint_io.py``).

``predictions`` runs flip-TTA over the frozen ViT, the projection head, the
low-resolution linear and cluster probes upsampled to ``label_res``, the
dense CRF on both probes and the argmax; ``make_eval_step`` adds the
[K, C] confusion blocks. Each step is a plain callable under
``torch.inference_mode()``; nothing is compiled, and every tensor stays on
the device of the image it was given. With a process ``group``
(``parallel.dist``) each rank runs its rows of the global batch: the eval
and validation steps all-reduce their confusion blocks and the predict
step all-gathers its label maps along the batch, as the JAX steps do over
their mesh. The ``backbone_sub_batch`` chunking and the ``batch_shards``
CRF hint of the JAX package (TPU workarounds) are not ported.

Spans (``utils.profiling``): the eval step is ``eval.step``; under it,
``logits`` (the flip-TTA, the projection head and both probes resized to
``label_res``, with each backbone forward a ``backbone`` inside), ``crf``
(the CRF with its guidance) and ``confusion`` twice: the two argmaxes,
which end ``predictions`` (the eval step calls it whole), then the
confusion blocks, a ``host_sync`` each, and their sum over the group. The
predict step opens ``logits`` and ``crf`` alone.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from depthg_tpu_torch.models import featurizer as featurizer_lib
from depthg_tpu_torch.models.featurizer_depth import DepthFeaturizerConfig
from depthg_tpu_torch.models.pyramid import PyramidConfig
from depthg_tpu_torch.models.vit import VisionTransformer
from depthg_tpu_torch.models.probes import ClusterLookup, cluster_lookup_apply, \
    cluster_lookup_resized
from depthg_tpu_torch.ops.crf import CRFConfig, crf_config_from_cfg, \
    dense_crf_multi_batch
from depthg_tpu_torch.ops.resize import resize_bilinear
from depthg_tpu_torch.parallel import dist
from depthg_tpu_torch.utils import profiling
from depthg_tpu_torch.utils.metrics import confusion_update


# the normalization of depthg_tpu/data/transforms.py (ImageNet statistics)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    n_classes: int
    extra_clusters: int = 0
    run_crf: bool = True
    label_res: int = 320
    cluster_alpha: float = 2.0
    crf: CRFConfig = CRFConfig()
    precision: str | None = None  # "float32" forces the eager attention path
    backbone_dtype: str = "float32"  # "bfloat16": frozen ViT in bf16
    # stack the flip-TTA pair into one [2B] backbone forward (same per-sample
    # math; False runs two sequential [B] passes, as the JAX default)
    fused_tta: bool = False
    # probes at code resolution, then upsampled: exact restructuring of the
    # reference's resize -> probe order (False materializes the resized code)
    lowres_probes: bool = True


class Segmenter(nn.Module):
    """The modules of the reference Lightning segmenter: ``net``
    (featurizer), ``linear_probe`` (1x1 conv) and ``cluster_probe``; with
    ``decoder=True`` also the training side's ``decoder`` (1x1 conv
    dim -> n_feats of the reconstruction loss), under its Lightning key."""

    def __init__(self, fcfg, n_classes: int, n_clusters: int, decoder: bool = False):
        super().__init__()
        self.net = featurizer_lib.build(fcfg)
        self.linear_probe = nn.Conv2d(fcfg.dim, n_classes, 1)
        self.cluster_probe = ClusterLookup(fcfg.dim, n_clusters)
        if decoder:
            self.decoder = nn.Conv2d(fcfg.dim, fcfg.n_feats, 1)

    def init_weights(self, generator: torch.Generator) -> "Segmenter":
        """Random weights from ``generator`` alone (the JAX package's init
        distributions): the featurizer's own (DINO init for the ViT),
        torch's default uniform bound 1/sqrt(fan_in) for the probe's and
        the decoder's 1x1 convs, normal cluster centroids."""
        self.net.init_weights(generator)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith("net."):
                    continue
                if name == "cluster_probe.clusters":
                    p.normal_(generator=generator)
                    continue
                conv = self.get_submodule(name.rsplit(".", 1)[0])
                bound = conv.in_channels ** -0.5
                p.uniform_(-bound, bound, generator=generator)
        return self.eval()

    @classmethod
    def from_state_dict(cls, sd: dict, fcfg: featurizer_lib.FeaturizerConfig,
                        backbone_dtype: str | None = None):
        """Build with the probe sizes of ``sd`` (and its decoder, if it has
        one) and load it strictly. For the eval CLI, demo and serve, whose
        every forward runs at ``backbone_dtype``: with ``"bfloat16"`` a
        frozen ViT is stored in bf16, so that it is not held in float32
        beside its bf16 copy (the same bits: the copy is its cast)."""
        model = cls(fcfg, sd["linear_probe.weight"].shape[0],
                    sd["cluster_probe.clusters"].shape[0],
                    decoder="decoder.weight" in sd)
        model.load_state_dict(sd, strict=True)
        if backbone_dtype == "bfloat16" and isinstance(model.net.model, VisionTransformer):
            model.net.model.to(torch.bfloat16)
        return model.eval()


def unnormalize_255(img: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalized [B,3,H,W] -> raw 0..255 floats for CRF guidance.
    On CUDA each statistic's copy from the host waits for the stream's
    queued work (a ``host_sync``)."""
    with profiling.host_sync():
        mean = torch.tensor(IMAGENET_MEAN, device=img.device)[None, :, None, None]
    with profiling.host_sync():
        std = torch.tensor(IMAGENET_STD, device=img.device)[None, :, None, None]
    return (img * std + mean).clamp(0.0, 1.0) * 255.0


def tta_code(net, img: torch.Tensor, precision=None, backbone_dtype=None,
             fused: bool = False) -> torch.Tensor:
    """Flip-TTA averaged projection code (eval: every sample independent)."""
    def forward(x):
        return featurizer_lib.dispatch_apply(
            net, x, precision=precision, backbone_dtype=backbone_dtype)["code"]

    flipped = torch.flip(img, dims=[-1])
    if not fused:
        return (forward(img) + torch.flip(forward(flipped), dims=[-1])) / 2
    b = img.shape[0]
    code = forward(torch.cat([img, flipped], dim=0))
    return (code[:b] + torch.flip(code[b:], dims=[-1])) / 2


def eval_logits(model: Segmenter, img: torch.Tensor, ecfg: EvalConfig,
                normalized: bool = True):
    """Upsampled probe outputs: (linear log-softmax, cluster log-probs), or
    raw shift-equivalent logits with ``normalized=False``."""
    code = tta_code(model.net, img, ecfg.precision,
                    backbone_dtype=ecfg.backbone_dtype,
                    fused=ecfg.fused_tta).float()
    res = (ecfg.label_res, ecfg.label_res)
    clusters = model.cluster_probe.clusters

    def norm_log(x):
        return torch.log_softmax(x, dim=1) if normalized else x

    if ecfg.lowres_probes:
        linear_log = norm_log(resize_bilinear(model.linear_probe(code), res))
        cluster_log = cluster_lookup_resized(clusters, code, res,
                                             ecfg.cluster_alpha, normalized)
        return linear_log, cluster_log
    code = resize_bilinear(code, res)
    return (norm_log(model.linear_probe(code)),
            cluster_lookup_apply(clusters, code, ecfg.cluster_alpha, normalized))


def _scores(model: Segmenter, img: torch.Tensor, ecfg: EvalConfig):
    """(linear, cluster) raw logits at ``label_res``, through the CRF when
    ``run_crf``: a ``logits`` span, then a ``crf`` span."""
    with profiling.span("logits"):
        linear_log, cluster_log = eval_logits(model, img, ecfg, normalized=False)
    if ecfg.run_crf:
        with profiling.span("crf"):
            guidance = unnormalize_255(img)
            if guidance.shape[-1] != ecfg.label_res:
                guidance = resize_bilinear(guidance, (ecfg.label_res, ecfg.label_res))
            # one mean field: both probes share each image's pairwise kernel
            linear_log, cluster_log = dense_crf_multi_batch(
                guidance, [linear_log, cluster_log], ecfg.crf)
    return linear_log, cluster_log


def _labels(linear_log: torch.Tensor, cluster_log: torch.Tensor):
    return (linear_log.argmax(1).to(torch.int32),
            cluster_log.argmax(1).to(torch.int32))


def predictions(model: Segmenter, img: torch.Tensor, ecfg: EvalConfig):
    """(linear_preds, cluster_preds) [B, R, R] int32, with optional CRF: the
    labels the eval step scores, so their argmaxes open its first
    ``confusion`` span."""
    scores = _scores(model, img, ecfg)
    with profiling.span("confusion"):
        return _labels(*scores)


def _sum_blocks(blocks, group):
    """The confusion blocks summed over the ranks of ``group`` (in place)."""
    if group is not None:
        for b in blocks:
            torch.distributed.all_reduce(b, group=group)
    return blocks


def make_eval_step(ecfg: EvalConfig, group=None):
    """(model, img, label) -> (linear_stats, cluster_stats) confusion blocks,
    on the image's device. With a process ``group`` the image is this
    rank's rows and the blocks are summed over the group."""

    @torch.inference_mode()
    def step(model, img, label):
        with profiling.span("eval.step"):
            linear_preds, cluster_preds = predictions(model, img, ecfg)
            with profiling.span("confusion"):
                return _sum_blocks((confusion_update(linear_preds, label, ecfg.n_classes, 0),
                                    confusion_update(cluster_preds, label, ecfg.n_classes,
                                                     ecfg.extra_clusters)), group)

    return step


def make_predict_step(ecfg: EvalConfig, group=None):
    """(model, img) -> (linear_preds, cluster_preds) for demo output. With
    a process ``group`` the image is this rank's rows and the label maps
    of every rank come back in rank order."""

    @torch.inference_mode()
    def step(model, img):
        preds = _labels(*_scores(model, img, ecfg))
        if group is None:
            return preds
        return tuple(dist.all_gather(p, group) for p in preds)

    return step


def make_validation_step(n_classes: int, extra_clusters: int = 0, group=None):
    """Training-time validation (no TTA, no CRF): (model, img, label,
    label_res) -> (linear_stats, cluster_stats). Plain float32 forward,
    upsampled code, argmax of the linear probe and of the cluster inner
    products, two confusion blocks (summed over ``group``, as
    ``make_eval_step``)."""

    @torch.inference_mode()
    def step(model, img, label, label_res):
        code = featurizer_lib.dispatch_apply(model.net, img)["code"]
        code = resize_bilinear(code, (label_res, label_res))
        linear_preds = model.linear_probe(code).argmax(1)
        _, cluster_probs = cluster_lookup_apply(model.cluster_probe.clusters, code,
                                                None, log_probs=False)
        cluster_preds = cluster_probs.argmax(1)
        return _sum_blocks((confusion_update(linear_preds, label, n_classes, 0),
                            confusion_update(cluster_preds, label, n_classes,
                                             extra_clusters)), group)

    return step


def fcfg_from_run_cfg(cfg):
    """The featurizer config of a reference-style run config, by ``arch``:
    ``DepthFeaturizerConfig`` for ``dino_depth`` (so that its eval takes
    the no-depth embed), ``PyramidConfig`` for ``feature-pyramid``,
    ``FeaturizerConfig`` otherwise."""
    kwargs = dict(
        arch=cfg.get("model_type", "vit_small"),
        patch_size=int(cfg.get("dino_patch_size", 8)),
        feat_type=cfg.get("dino_feat_type", "feat"),
        projection_type=cfg.get("projection_type", "nonlinear"),
        dim=int(cfg.get("dim", 70)),
        dropout=bool(cfg.get("dropout", True)),
        attention_impl=str(cfg.get("attention_impl", "auto")),
    )
    if cfg.get("arch") == "dino_depth":
        return DepthFeaturizerConfig(guidance=str(cfg.get("guidance", "none")), **kwargs)
    if cfg.get("arch") == "feature-pyramid":
        return PyramidConfig(granularity=int(cfg.get("granularity", 1)),
                             dim=int(cfg.get("dim", 70)),
                             continuous=bool(cfg.get("continuous", True)))
    return featurizer_lib.FeaturizerConfig(**kwargs)


def ecfg_from_checkpoint(cfg, sd: dict, run_cfg, n_classes: int | None = None,
                         extra_clusters: int | None = None) -> EvalConfig:
    """EvalConfig from a loaded checkpoint's state dict + CLI cfg, with the
    JAX package's defaults (bf16 backbone, ``fused_tta=True``)."""
    if n_classes is None:
        n_classes = int(run_cfg.get("n_classes", 27))
    if extra_clusters is None:
        rows = sd["cluster_probe.clusters"].shape[0]
        extra_clusters = rows - n_classes if rows > n_classes else 0
    return EvalConfig(
        n_classes=int(n_classes), extra_clusters=int(extra_clusters),
        run_crf=bool(cfg.run_crf), label_res=int(cfg.res),
        crf=crf_config_from_cfg(cfg),
        precision=cfg.get("matmul_precision"),
        backbone_dtype=str(cfg.get("backbone_dtype", "bfloat16")),
        fused_tta=bool(cfg.get("fused_tta", True)),
    )
