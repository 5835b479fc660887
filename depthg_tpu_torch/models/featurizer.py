"""DINO featurizer: frozen ViT patch features + trainable projection head
(``depthg_tpu/models/featurizer.py``).

The module tree follows the reference Lightning layout (``net.model.*``,
``net.cluster1.0``, ``net.cluster2.{0,2}``) so checkpoints load with
``strict=True``. The backbone never takes part in a backward pass: it runs
under ``torch.no_grad()``. In train mode ``cluster1`` and ``cluster2`` each
see an independently Dropout2d-masked copy of the features, and the returned
``feats`` carry a mask of their own; every mask comes from the caller's
``torch.Generator``. ``dispatch_apply`` routes a config to its
featurizer: this one, the depth-fused ``dino_depth``
(``models/featurizer_depth.py``) or the ``feature-pyramid``
(``models/pyramid.py``); it is the one entry of train, validation and TTA
eval.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.func import functional_call

from depthg_tpu_torch.models import frozen_cache
from depthg_tpu_torch.models import vit as vit_lib
from depthg_tpu_torch.models.layers import conv1x1, dropout2d
from depthg_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class FeaturizerConfig:
    arch: str = "vit_small"          # cfg.model_type in the reference
    patch_size: int = 8              # cfg.dino_patch_size
    feat_type: str = "feat"          # "feat" | "KK"
    projection_type: str | None = "nonlinear"  # "nonlinear" | "linear" | None
    dim: int = 70                    # projection output dim
    dropout: bool = True             # cfg.dropout: Dropout2d on the returned feats
    drop_rate: float = 0.1
    vit_config: vit_lib.ViTConfig | None = None  # override (tests)
    # "auto" = the Hopper attention kernel on CUDA when the attention matrix
    # isn't consumed, eager "xla" otherwise; "xla" | "flash" | "fused" force
    attention_impl: str = "auto"

    @property
    def vit(self) -> vit_lib.ViTConfig:
        if self.vit_config is not None:
            return self.vit_config
        return vit_lib.make_config(self.arch, self.patch_size)

    @property
    def n_feats(self) -> int:
        return self.vit.embed_dim


class DinoFeaturizer(nn.Module):
    def __init__(self, fcfg: FeaturizerConfig):
        super().__init__()
        self.fcfg = fcfg
        nf = fcfg.n_feats
        self.model = vit_lib.VisionTransformer(fcfg.vit)
        if fcfg.projection_type is not None:
            self.cluster1 = nn.Sequential(conv1x1(nf, fcfg.dim))
        if fcfg.projection_type == "nonlinear":
            self.cluster2 = nn.Sequential(conv1x1(nf, nf), nn.ReLU(),
                                          conv1x1(nf, fcfg.dim))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DinoFeaturizer":
        """DINO's init for the ViT, then the projection head's 1x1 convs
        uniform(+-1/sqrt(in)), all from ``generator``."""
        self.model.init_weights(generator)
        for name, p in self.named_parameters():
            if name.startswith(("cluster1.", "cluster2.")):
                bound = self.get_submodule(name.rsplit(".", 1)[0]).in_channels ** -0.5
                p.uniform_(-bound, bound, generator=generator)
        return self


def bf16_parameters(module: nn.Module, names=None) -> dict:
    """bf16 copies of ``module``'s parameters (or of those in ``names``) by
    name, cast by one multi-tensor copy (a ``.to`` per tensor is one launch
    each, 150 for a ViT-S, and the forward is bound by the host's launch
    rate); a parameter stored in bf16 is passed as it is. While gradients
    are off the copies are made once per set of weights and kept with
    ``module`` (``frozen_cache``)."""
    def cast():
        named = (list(module.named_parameters()) if names is None
                 else [(n, module.get_parameter(n)) for n in names])
        out = {n: p if p.dtype == torch.bfloat16 else torch.empty_like(p, dtype=torch.bfloat16)
               for n, p in named}
        todo = [(out[n], p) for n, p in named if out[n] is not p]
        if todo:
            torch._foreach_copy_([c for c, _ in todo], [p for _, p in todo])
        return out

    if torch.is_grad_enabled():
        return cast()
    if names is None:
        sources = list(module.parameters())
    else:
        names = tuple(names)
        sources = [module.get_parameter(n) for n in names]
    return frozen_cache.derived(module, ("bf16", names), sources, cast)


@torch.no_grad()
def backbone_features(net: DinoFeaturizer, img: torch.Tensor,
                      precision: str | None = None,
                      backbone_dtype: str | None = None, need_attn: bool = False):
    """Frozen-backbone dense features [B, C, H/ps, W/ps] (float32) plus the
    last block's attention (None under the kernel). ``need_attn`` (LHP's
    attention propagation) takes the eager path for the whole forward. The
    class token and a DINOv2 backbone's registers are dropped from the
    features (the attention keeps every token).

    ``backbone_dtype="bfloat16"`` runs the ViT with its parameters and the
    image cast to bf16 for this call (the module keeps float32 weights) and
    returns float32 features. ``backbone_dtype="int8"`` runs the int8
    copy of the ViT (``vit.int8_copy``: w8a8 block linears, bf16 elsewhere,
    derived once per set of weights) on the image in bf16. The forward,
    the weights' cast included, is one ``backbone`` span
    (``utils.profiling``)."""
    fcfg = net.fcfg
    vcfg = fcfg.vit
    if img.shape[2] % vcfg.patch_size or img.shape[3] % vcfg.patch_size:
        raise ValueError(f"image {tuple(img.shape)} is not a multiple of the "
                         f"patch size {vcfg.patch_size}")
    fh, fw = img.shape[2] // vcfg.patch_size, img.shape[3] // vcfg.patch_size
    if backbone_dtype not in (None, "float32", "bfloat16", "int8"):
        raise ValueError(f"unknown backbone_dtype {backbone_dtype!r}; "
                         "expected float32 | bfloat16 | int8")
    with profiling.span("backbone"):
        impl = vit_lib.resolve_attn_impl(fcfg.attention_impl, precision, img.device,
                                          need_attn)
        if backbone_dtype == "bfloat16":
            feats, attns, qkvs = functional_call(
                net.model, bf16_parameters(net.model), (img.to(torch.bfloat16),),
                {"n": 1, "attn_impl": impl})
        elif backbone_dtype == "int8":
            feats, attns, qkvs = vit_lib.int8_copy(net.model)(
                img.to(torch.bfloat16), n=1, attn_impl=impl)
        else:
            feats, attns, qkvs = net.model(img, n=1, attn_impl=impl)
        feat, attn, qkv = feats[0].float(), attns[0], qkvs[0].float()
        if attn is not None:
            attn = attn.float()

        # the patch tokens follow the class token and any registers
        if fcfg.feat_type == "feat":
            b = feat.shape[0]
            image_feat = feat[:, vcfg.n_prefix:].reshape(b, fh, fw, -1).permute(0, 3, 1, 2)
        elif fcfg.feat_type == "KK":
            k = qkv[1][:, :, vcfg.n_prefix:, :]  # [B, h, HW, hd] keys of the last block
            b, nh, _, hd = k.shape
            image_feat = (k.reshape(b, nh, fh, fw, hd).permute(0, 1, 4, 2, 3)
                          .reshape(b, nh * hd, fh, fw))
        else:
            raise ValueError(f"Unknown feat type: {fcfg.feat_type}")
        return image_feat, attn


def project(net: DinoFeaturizer, image_feat: torch.Tensor, train: bool = False,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """cluster1(drop(x)) [+ cluster2(drop(x))], the two masks independent;
    no dropout in eval mode."""
    fcfg = net.fcfg
    if fcfg.projection_type is None:
        return image_feat
    code = net.cluster1(dropout2d(image_feat, fcfg.drop_rate, train, generator))
    if fcfg.projection_type == "nonlinear":
        code = code + net.cluster2(dropout2d(image_feat, fcfg.drop_rate, train,
                                             generator))
    return code


def featurizer_apply(net: DinoFeaturizer, img: torch.Tensor,
                     precision: str | None = None,
                     backbone_dtype: str | None = None, train: bool = False,
                     generator: torch.Generator | None = None,
                     need_attn: bool = False) -> dict:
    """dict(feats, code, attn). With ``train=True`` the projection sees
    dropout-masked features and, under ``fcfg.dropout``, the returned
    ``feats`` carry their own mask; gradients reach the projection head
    only."""
    image_feat, attn = backbone_features(net, img, precision, backbone_dtype, need_attn)
    code = project(net, image_feat, train, generator)
    feats = image_feat
    if net.fcfg.dropout:
        feats = dropout2d(image_feat, net.fcfg.drop_rate, train, generator)
    return {"feats": feats, "code": code, "attn": attn}


def build(fcfg) -> nn.Module:
    """The featurizer module of a config: ``FeaturizerConfig``,
    ``DepthFeaturizerConfig`` or ``PyramidConfig``."""
    from depthg_tpu_torch.models.featurizer_depth import (DepthFeaturizerConfig,
                                                          DinoDepthFeaturizer)
    from depthg_tpu_torch.models.pyramid import FeaturePyramidNet, PyramidConfig

    if isinstance(fcfg, PyramidConfig):
        return FeaturePyramidNet(fcfg)
    if isinstance(fcfg, DepthFeaturizerConfig):
        return DinoDepthFeaturizer(fcfg)
    return DinoFeaturizer(fcfg)


def dispatch_apply(net: nn.Module, img: torch.Tensor, depth: torch.Tensor | None = None,
                   precision: str | None = None, backbone_dtype: str | None = None,
                   train: bool = False, generator: torch.Generator | None = None,
                   need_attn: bool = False) -> dict:
    """The featurizer forward of ``net``'s config: the pyramid (depth,
    attention and dropout unused; no ``precision`` knob, float32 or bf16 is
    the whole choice), the depth-fused forward (without depth in eval: the
    no-depth embed), or the plain DINO featurizer."""
    from depthg_tpu_torch.models.featurizer_depth import (DepthFeaturizerConfig,
                                                          depth_featurizer_apply)
    from depthg_tpu_torch.models.pyramid import PyramidConfig, pyramid_featurizer_apply

    fcfg = net.fcfg
    if isinstance(fcfg, PyramidConfig):
        return pyramid_featurizer_apply(net, img, backbone_dtype, train)
    if isinstance(fcfg, DepthFeaturizerConfig):
        return depth_featurizer_apply(net, img, depth, precision, need_attn,
                                      backbone_dtype, train, generator)
    return featurizer_apply(net, img, precision, backbone_dtype, train, generator, need_attn)
