"""ZoeDepth (single metric head, ``depthg_tpu/models/zoedepth/model.py``) as an ``nn.Module``.

BEiT-L/384 encoder -> DPT decoder -> bottleneck conv -> softplus seed bins
-> 4 inverse-attractor stages over the decoder scales -> conditional
log-binomial over 64 bins -> depth = sum p c (the full-resolution tail in
one kernel, ``ops.zoe_bins``, for a bf16 head on the card at inference).
``zoedepth_infer`` adds the reference's reflect pad and horizontal-flip
TTA, and ``prep`` the MiDaS prep resize (keep aspect, multiples of 32,
"minimal", 0.5/0.5 normalization). ``ZoeDepth.forward`` is
``zoedepth_forward``; it opens the spans ``backbone`` (BEiT, its bias
lookup included), ``dpt`` (the decoder) and ``bins`` (``conv2`` through
the log-binomial and the depth sum) of ``utils.profiling``.

Module names are those of the released ``ZoeD_M12_N.pt``
(``core.core.pretrained.model.*`` for BEiT, ``core.core.pretrained.act_postprocess*``
and ``core.core.scratch.*`` for the decoder, ``conv2``, ``seed_bin_regressor``,
``seed_projector``, ``projectors``, ``attractors``, ``conditional_log_binomial``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from depthg_tpu_torch.models.zoedepth import heads
from depthg_tpu_torch.models.zoedepth.beit import BEiT, BEiTConfig
from depthg_tpu_torch.models.zoedepth.dpt import DPT, DPTConfig
from depthg_tpu_torch.models.zoedepth.layers import conv2d, init_uniform_
from depthg_tpu_torch.ops import zoe_bins
from depthg_tpu_torch.ops.resize import resize_bicubic, resize_bilinear
from depthg_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class ZoeConfig:
    n_bins: int = 64
    bin_embedding_dim: int = 128
    bin_centers_type: str = "softplus"
    min_depth: float = 1e-3
    max_depth: float = 10.0
    n_attractors: tuple = (16, 8, 4, 1)
    attractor_alpha: float = 1000.0
    attractor_gamma: float = 2.0
    attractor_kind: str = "mean"
    attractor_type: str = "inv"
    min_temp: float = 0.0212
    max_temp: float = 50.0
    inverse_midas: bool = False
    img_size: tuple = (384, 512)
    beit: BEiTConfig = BEiTConfig()
    dpt: DPTConfig = DPTConfig()
    n_midas_out: int = 32


class ZoeDepth(nn.Module):
    def __init__(self, cfg: ZoeConfig):
        super().__init__()
        self.cfg = cfg
        f, emb = cfg.dpt.features, cfg.bin_embedding_dim
        normed = cfg.bin_centers_type in ("normed", "hybrid2")
        self.core = nn.Module()
        self.core.core = DPT(BEiT(cfg.beit), cfg.dpt)
        self.conv2 = conv2d(f, f, 1)
        self.seed_bin_regressor = heads.SeedBinRegressor(f, cfg.n_bins)
        self.seed_projector = heads.Projector(f, emb)
        self.projectors = nn.ModuleList(heads.Projector(f, emb) for _ in cfg.n_attractors)
        self.attractors = nn.ModuleList(heads.Attractor(emb, n * 2 if normed else n)
                                        for n in cfg.n_attractors)
        last_in = cfg.n_midas_out + 1
        self.conditional_log_binomial = heads.ConditionalLogBinomial(
            last_in, emb, cfg.n_bins, (last_in + emb) // 2, cfg.min_temp, cfg.max_temp)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ZoeDepth":
        """``zoedepth_init``'s distributions (BEiT: trunc_normal(.02) and
        LayerScale at ``layer_scale_init``; convolutions uniform
        (+-1/sqrt(fan_in)))."""
        dpt = self.core.core
        dpt.pretrained.model.init_weights(generator)
        dpt.init_decoder(generator)
        for name, m in self.named_children():
            if name != "core":
                init_uniform_(m, generator)
        return self

    def forward(self, x: torch.Tensor, return_probs: bool = False,
                attn_impl: str | None = None) -> dict:
        """x: prep-normalized [B, 3, H, W], H and W multiples of 32 ->
        dict(rel_depth, metric_depth [B, 1, H, W], feats[, probs, bin_centers]).
        ``attn_impl`` (auto | xla | fused) defaults to ``cfg.beit.attn_impl``."""
        cfg = self.cfg
        dpt = self.core.core
        with profiling.span("backbone"):
            taps, grid = dpt.pretrained.model(x, attn_impl)
        with profiling.span("dpt"):
            rel_depth, hooks = dpt.decode(taps, grid)
        with profiling.span("bins"):
            return self._bins(rel_depth, hooks, return_probs)

    def _bins(self, rel_depth, hooks, return_probs):
        """The metric-bins head on the decoder's outputs."""
        cfg = self.cfg
        xh = self.conv2(hooks["l4_rn"])
        normed = cfg.bin_centers_type != "softplus"
        _, seed_centers = self.seed_bin_regressor(
            xh, "normed" if normed else "softplus", cfg.min_depth, cfg.max_depth)
        b_prev = ((seed_centers - cfg.min_depth) / (cfg.max_depth - cfg.min_depth)
                  if normed else seed_centers)
        prev_emb = self.seed_projector(xh)

        b_centers = seed_centers
        for proj, attr, blk in zip(self.projectors, self.attractors,
                                   (hooks["r4"], hooks["r3"], hooks["r2"], hooks["r1"])):
            emb = proj(blk)
            b_prev, b_centers = attr(emb, b_prev, prev_emb, kind=cfg.attractor_kind,
                                     attractor_type=cfg.attractor_type, normed=normed,
                                     min_depth=cfg.min_depth, max_depth=cfg.max_depth)
            prev_emb = emb

        last = hooks["out_conv"]
        rel = rel_depth[:, None]
        if cfg.inverse_midas:
            rel = 1.0 / (rel + 1e-6)
            lo = rel.amin(dim=(1, 2, 3), keepdim=True)  # per image
            hi = rel.amax(dim=(1, 2, 3), keepdim=True)
            rel = (rel - lo) / (hi - lo)
        rel = resize_bilinear(rel, last.shape[-2:], align_corners=True)

        # the full-resolution tail: the kernel where it takes the call (a bf16
        # head at the released widths on the card, gradients off), else the
        # module's code. The kernel reads channels-last maps, as the decoder
        # leaves them for a batch of several images (of one image, in NCHW).
        clb = self.conditional_log_binomial
        if not return_probs and zoe_bins.takes(last, rel, prev_emb, b_centers, clb):
            last, prev_emb, b_centers = (t.contiguous(memory_format=torch.channels_last)
                                         for t in (last, prev_emb, b_centers))
            depth, emb_up = zoe_bins.bins_tail(last, rel.contiguous(), prev_emb, b_centers, clb)
            return {"rel_depth": rel_depth, "metric_depth": depth, "feats": emb_up}
        depth, emb_up, probs, centers_up = zoe_bins.bins_tail_plain(
            last, rel, prev_emb, b_centers, clb)
        out = {"rel_depth": rel_depth, "metric_depth": depth, "feats": emb_up}
        if return_probs:
            out["probs"] = probs
            out["bin_centers"] = centers_up
        return out


def prep_size(h: int, w: int, cfg: ZoeConfig, keep_aspect_ratio: bool = True,
              resize_method: str = "minimal", multiple: int = 32) -> tuple:
    """MiDaS Resize.get_size: target (net_h, net_w) = cfg.img_size, each side
    a multiple of ``multiple`` (ZoeDepth's 32; Depth Anything V2's 14)."""
    net_h, net_w = cfg.img_size
    scale_h = net_h / h
    scale_w = net_w / w
    if keep_aspect_ratio:
        if resize_method == "lower_bound":
            scale_h = scale_w = max(scale_h, scale_w)
        elif resize_method == "upper_bound":
            scale_h = scale_w = min(scale_h, scale_w)
        elif resize_method == "minimal":
            pick = scale_w if abs(1 - scale_w) < abs(1 - scale_h) else scale_h
            scale_h = scale_w = pick
        else:
            raise ValueError(resize_method)

    def mult(x, min_val=0, max_val=None):
        y = int(np.round(x / multiple) * multiple)
        if max_val is not None and y > max_val:
            y = int(np.floor(x / multiple) * multiple)
        if y < min_val:
            y = int(np.ceil(x / multiple) * multiple)
        return y

    if resize_method == "lower_bound":
        return mult(scale_h * h, min_val=net_h), mult(scale_w * w, min_val=net_w)
    if resize_method == "upper_bound":
        return mult(scale_h * h, max_val=net_h), mult(scale_w * w, max_val=net_w)
    return mult(scale_h * h), mult(scale_w * w)


def prep(x: torch.Tensor, cfg: ZoeConfig) -> torch.Tensor:
    """Resize (bilinear, align_corners=True) + 0.5/0.5 normalize."""
    nh, nw = prep_size(x.shape[-2], x.shape[-1], cfg)
    x = resize_bilinear(x, (nh, nw), align_corners=True)
    return (x - 0.5) / 0.5


def infer_with_pad(model: ZoeDepth, x: torch.Tensor, pad_input: bool = True,
                   fh: float = 3.0, fw: float = 3.0, attn_impl: str | None = None):
    """Reflect pad by int(sqrt(side / 2) x 3), prep, forward, bicubic back to
    the padded size, crop: (metric depth [B, 1, H, W], feats)."""
    h, w = x.shape[-2:]
    pad_h = int(math.sqrt(h / 2) * fh) if pad_input else 0
    pad_w = int(math.sqrt(w / 2) * fw) if pad_input else 0
    if pad_input:
        x = F.pad(x, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    out = model(prep(x, model.cfg), attn_impl=attn_impl)
    depth, feats = out["metric_depth"], out["feats"]
    if depth.shape[-2:] != x.shape[-2:]:
        depth = resize_bicubic(depth, x.shape[-2:])
    if pad_h > 0:
        depth = depth[:, :, pad_h:-pad_h, :]
    if pad_w > 0:
        depth = depth[:, :, :, pad_w:-pad_w]
    return depth, feats


def zoedepth_infer(model: ZoeDepth, x: torch.Tensor, pad_input: bool = True,
                   with_flip_aug: bool = True, return_feats: bool = False,
                   attn_impl: str | None = None):
    """Reference ``DepthModel.infer``: reflect pad + flip TTA, averaged.

    x: raw [B, 3, H, W] in [0, 1] (ToTensor scale, not ImageNet-normalized);
    ``attn_impl`` as in ``ZoeDepth.forward``."""
    depth, feats = infer_with_pad(model, x, pad_input, attn_impl=attn_impl)
    if with_flip_aug:
        depth_f, feats_f = infer_with_pad(model, x.flip(-1), pad_input, attn_impl=attn_impl)
        depth = (depth + depth_f.flip(-1)) / 2
        feats = (feats + feats_f.flip(-1)) / 2
    if return_feats:
        return depth, feats
    return depth
