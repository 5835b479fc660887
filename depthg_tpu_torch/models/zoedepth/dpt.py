"""DPT decoder of MiDaS 3.x (``depthg_tpu/models/zoedepth/dpt.py``) as ``nn.Module``s.

Readout projection of the cls token (exact GELU; or MiDaS's parameter-free
slice readout when a file has no readout keys), 4-scale reassembly
(deconv x4, deconv x2, identity, stride-2 conv), 3x3 ``rn`` projections,
RefineNet fusion blocks with residual conv units (``align_corners=True``
resizes) and the monocular-depth head. ``decode`` returns the relative
depth and the six activations the reference taps (``out_conv``, ``l4_rn``,
``r4``, ``r3``, ``r2``, ``r1``); it is ``fuse`` (reassembly through
``refinenet1``) then ``head`` (``output_conv``), whose resize goes to twice
the finest map (MiDaS's) or to a size the caller gives (Depth Anything
V2's: the input's).

Module names are those of the released files: an encoder wrapped in
``DPT`` lays out as ``pretrained.model.*``, ``pretrained.act_postprocess{1..4}.*``
and ``scratch.*`` (``layer{i}_rn``, ``refinenet{i}.{resConfUnit1,
resConfUnit2, out_conv}``, ``output_conv.{0,2,4}``); ZoeDepth nests it as
``core.core``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from depthg_tpu_torch.models.zoedepth.layers import conv2d, deconv_kxk, init_uniform_, trunc_normal_
from depthg_tpu_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    embed_dim: int = 1024
    features: int = 256
    reassemble_channels: tuple = (256, 512, 1024, 1024)
    # False: MiDaS's parameter-free slice readout (a file without
    # ``act_postprocess{i}.0.project`` keys)
    project_readout: bool = True


class ProjectReadout(nn.Module):
    """Patch tokens concatenated with the cls token -> Linear -> exact GELU."""

    def __init__(self, d: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * d, d), nn.GELU())

    def forward(self, tok: torch.Tensor) -> torch.Tensor:
        patches = tok[:, 1:]
        return self.project(torch.cat([patches, tok[:, :1].expand_as(patches)], dim=-1))


class SliceReadout(nn.Module):
    def forward(self, tok: torch.Tensor) -> torch.Tensor:
        return tok[:, 1:]


def _postprocess(cfg: DPTConfig, i: int) -> nn.Sequential:
    """act_postprocess{i+1}: (readout, 2 parameter-free reshapes, 1x1
    project[, resample]) at the released file's indices 0, 3, 4."""
    d, ch = cfg.embed_dim, cfg.reassemble_channels[i]
    layers = [ProjectReadout(d) if cfg.project_readout else SliceReadout(),
              nn.Identity(), nn.Identity(), conv2d(d, ch, 1)]
    if i == 0:
        layers.append(deconv_kxk(ch, ch, 4))
    elif i == 1:
        layers.append(deconv_kxk(ch, ch, 2))
    elif i == 3:
        layers.append(conv2d(ch, ch, 3, stride=2, padding=1))
    return nn.Sequential(*layers)


class ResidualConvUnit(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1 = conv2d(f, f, 3, padding=1)
        self.conv2 = conv2d(f, f, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(x))
        return x + self.conv2(F.relu(y))


class FeatureFusionBlock(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(f)
        self.resConfUnit2 = ResidualConvUnit(f)
        self.out_conv = conv2d(f, f, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None, out_hw) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_bilinear(x, out_hw, align_corners=True)
        return self.out_conv(x)


class Scratch(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        f = cfg.features
        for i, ch in enumerate(cfg.reassemble_channels):
            setattr(self, f"layer{i + 1}_rn", conv2d(ch, f, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(f))
        # (conv, x2 resize, conv, ReLU, conv, ReLU): parameters at 0, 2, 4
        self.output_conv = nn.Sequential(conv2d(f, f // 2, 3, padding=1), nn.Identity(),
                                         conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
                                         conv2d(32, 1, 1), nn.ReLU())


class _Pretrained(nn.Module):
    def __init__(self, model: nn.Module, cfg: DPTConfig):
        super().__init__()
        self.model = model
        for i in range(4):
            setattr(self, f"act_postprocess{i + 1}", _postprocess(cfg, i))


class DPT(nn.Module):
    """An encoder (``pretrained.model``) with the DPT decoder around it."""

    def __init__(self, encoder: nn.Module, cfg: DPTConfig):
        super().__init__()
        self.pretrained = _Pretrained(encoder, cfg)
        self.scratch = Scratch(cfg)

    @torch.no_grad()
    def init_decoder(self, generator: torch.Generator) -> None:
        """``dpt_init``'s distributions: trunc_normal(.02) readout weights
        with zero biases, uniform(+-1/sqrt(fan_in)) convolutions."""
        for i in range(4):
            post = getattr(self.pretrained, f"act_postprocess{i + 1}")
            init_uniform_(post, generator)
            if isinstance(post[0], ProjectReadout):
                trunc_normal_(post[0].project[0].weight, generator)
                post[0].project[0].bias.zero_()
        init_uniform_(self.scratch, generator)

    def decode(self, taps, grid_hw):
        """taps: 4 token tensors [B, 1+N, D]; grid_hw: the patch grid (h, w).
        Returns (relative depth [B, H, W], hooks dict)."""
        return self.head(*self.fuse(taps, grid_hw))

    def fuse(self, taps, grid_hw):
        """Reassembly, the ``rn`` projections and the four fusion blocks:
        (``refinenet1``'s output [B, F, 8h, 8w], hooks dict)."""
        h, w = grid_hw
        maps = []
        for i, tok in enumerate(taps):
            post = getattr(self.pretrained, f"act_postprocess{i + 1}")
            proj = post[0](tok)
            fmap = post[3](proj.transpose(1, 2).reshape(proj.shape[0], -1, h, w))
            if len(post) > 4:
                fmap = post[4](fmap)
            maps.append(fmap)
        s = self.scratch
        l1, l2, l3, l4 = (getattr(s, f"layer{i + 1}_rn")(maps[i]) for i in range(4))

        hooks = {"l4_rn": l4}
        p4 = s.refinenet4(l4, None, l3.shape[-2:])
        hooks["r4"] = p4
        p3 = s.refinenet3(p4, l3, l2.shape[-2:])
        hooks["r3"] = p3
        p2 = s.refinenet2(p3, l2, l1.shape[-2:])
        hooks["r2"] = p2
        p1 = s.refinenet1(p2, l1, (l1.shape[-2] * 2, l1.shape[-1] * 2))
        hooks["r1"] = p1
        return p1, hooks

    def head(self, p1, hooks, out_hw=None):
        """``output_conv`` on ``refinenet1``'s output: a 3x3 convolution, the
        bilinear resize (``align_corners=True``) to ``out_hw`` (default x2),
        3x3 + ReLU (``hooks["out_conv"]``), 1x1 + ReLU. Returns (relative
        depth [B, H, W], hooks)."""
        head = self.scratch.output_conv
        y = head[0](p1)
        if out_hw is None:
            out_hw = (y.shape[-2] * 2, y.shape[-1] * 2)
        y = resize_bilinear(y, tuple(out_hw), align_corners=True)
        y = F.relu(head[2](y))
        hooks["out_conv"] = y
        y = F.relu(head[4](y))
        return y[:, 0], hooks
