"""The depth-fused DINO featurizer, ``arch=dino_depth``
(``depthg_tpu/models/featurizer_depth.py``).

The reference's ``DinoFeaturizerWithDepth``: a pyramid of k=2 s=2
convolutions (``depth_downscaling.i.conv``, each stage but the last
followed by a channel ``LayerNorm2d`` (``.ln``, eps 1e-6) and exact GELU)
embeds the depth map at the backbone's feature resolution, and
``guidance`` fuses it with the frozen ViT features before the projection
head:

* ``"sum"``: image features + depth embedding, in train mode only;
* ``"cross_attn"``: ``cross_attn`` (``nn.MultiheadAttention``'s layout,
  8 heads) with the depth tokens as queries and the image tokens as keys
  and values, in train mode when depth is given; otherwise (eval) the
  queries are the learned ``no_depth_embed`` broadcast over the grid.
  Dropout on the attention weights in train mode, from the caller's
  generator. The heads are 48 wide, so this is eager attention, not the
  Hopper kernel (head_dim 64 only);
* ``"none"``: the image features;
* ``"concat"`` raises: the reference leaves the fused features undefined
  there.

Only the train output carries ``orig_feats`` (the unfused features). Kept
from the reference: for n_feats other than 384 the pyramid has five stages
(32x down), which lines up with the patch-8 grid only at 384.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from depthg_tpu_torch.models import featurizer as base
from depthg_tpu_torch.models.layers import MultiheadAttention, dropout2d


@dataclasses.dataclass(frozen=True)
class DepthFeaturizerConfig(base.FeaturizerConfig):
    guidance: str = "none"          # cfg.guidance: "cross_attn" | "sum" | "none"
    cross_attn_heads: int = 8
    cross_attn_dropout: float = 0.1


def _pyramid_channels(n_feats: int) -> list[int]:
    if n_feats == 384:
        return [1, 64, 128, 384]
    return [1, 64, 128, 256, 512, n_feats]


class LayerNorm2d(nn.Module):
    """Channel-dim layer norm on [B, C, H, W], computed in float32 (the
    reference's ``LayerNorm2d``)."""

    def __init__(self, ch: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=1, keepdim=True)
        var = (xf - mu).square().mean(dim=1, keepdim=True)
        y = (xf - mu) / torch.sqrt(var + self.eps)
        return (self.weight[None, :, None, None] * y
                + self.bias[None, :, None, None]).to(x.dtype)


class DepthStage(nn.Module):
    """One pyramid stage: a k=2 s=2 conv, then (all but the last stage)
    ``LayerNorm2d`` and exact GELU."""

    def __init__(self, in_ch: int, out_ch: int, norm: bool):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size=2, stride=2)
        self.ln = LayerNorm2d(out_ch) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.ln is not None:
            x = F.gelu(self.ln(x))
        return x


class DinoDepthFeaturizer(base.DinoFeaturizer):
    def __init__(self, fcfg: DepthFeaturizerConfig):
        nf = fcfg.n_feats
        chans = _pyramid_channels(nf)
        ps = fcfg.vit.patch_size
        if ps & (ps - 1):
            # backbone_features drops a DINOv2 backbone's registers, but the
            # depth pyramid's stride-2 stages meet no grid of such a patch
            raise ValueError(f"arch=dino_depth embeds depth by {len(chans) - 1} stride-2 "
                             f"stages, which line up with no grid of patch size {ps} "
                             f"(model_type={fcfg.arch!r}): use a patch-8 or 16 backbone")
        super().__init__(fcfg)
        self.depth_downscaling = nn.ModuleList(
            DepthStage(chans[i], chans[i + 1], i < len(chans) - 2)
            for i in range(len(chans) - 1))
        self.cross_attn = MultiheadAttention(nf, fcfg.cross_attn_heads)
        self.no_depth_embed = nn.Parameter(torch.zeros(1, nf))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DinoDepthFeaturizer":
        """The DINO featurizer's init, then the JAX package's distributions:
        convolutions and the attention's linears uniform(+-1/sqrt(fan_in)),
        unit layer norms, a standard normal ``no_depth_embed``."""
        super().init_weights(generator)
        for stage in self.depth_downscaling:
            bound = (stage.conv.in_channels * 4) ** -0.5
            stage.conv.weight.uniform_(-bound, bound, generator=generator)
            stage.conv.bias.uniform_(-bound, bound, generator=generator)
        bound = self.fcfg.n_feats ** -0.5
        for p in (self.cross_attn.in_proj_weight, self.cross_attn.in_proj_bias,
                  self.cross_attn.out_proj.weight, self.cross_attn.out_proj.bias):
            p.uniform_(-bound, bound, generator=generator)
        self.no_depth_embed.normal_(generator=generator)
        return self

    def depth_pyramid(self, depth: torch.Tensor) -> torch.Tensor:
        x = depth
        for stage in self.depth_downscaling:
            x = stage(x)
        return x


def depth_featurizer_apply(net: DinoDepthFeaturizer, img: torch.Tensor,
                           depth: torch.Tensor | None = None,
                           precision: str | None = None, need_attn: bool = False,
                           backbone_dtype: str | None = None, train: bool = False,
                           generator: torch.Generator | None = None) -> dict:
    """dict(feats=fused, code, attn) plus ``orig_feats`` in train mode."""
    fcfg = net.fcfg
    if fcfg.guidance == "concat":
        raise NotImplementedError(
            "guidance='concat' is a latent bug in the reference (fused feats "
            "left undefined, src/modules.py:564-565)")
    image_feat, attn = base.backbone_features(net, img, precision, backbone_dtype, need_attn)
    b, nf, fh, fw = image_feat.shape
    if depth is None:
        depth = torch.zeros((b, 1, fh * fcfg.patch_size, fw * fcfg.patch_size),
                            dtype=img.dtype, device=img.device)
        have_depth = False
    else:
        have_depth = True

    if train and fcfg.guidance == "sum":
        fused = image_feat + net.depth_pyramid(depth)
    elif fcfg.guidance == "cross_attn":
        img_tok = image_feat.reshape(b, nf, -1).transpose(1, 2)  # [B, P, D]
        if train and have_depth:
            d_tok = net.depth_pyramid(depth).reshape(b, nf, -1).transpose(1, 2)
        else:
            d_tok = net.no_depth_embed[None].expand(b, img_tok.shape[1], nf).to(img_tok.dtype)
        fused = net.cross_attn(d_tok, img_tok,
                               fcfg.cross_attn_dropout if train else 0.0, generator)
        fused = fused.transpose(1, 2).reshape(b, nf, fh, fw)
    else:
        fused = image_feat

    code = base.project(net, fused, train, generator)
    feats = fused
    if fcfg.dropout:
        feats = dropout2d(fused, fcfg.drop_rate, train, generator)
    out = {"feats": feats, "code": code, "attn": attn}
    if train:
        out["orig_feats"] = image_feat
    return out
