"""MiDaS v3 DPT_Large (ViT-L/16 + DPT decoder, ``depthg_tpu/models/midas_dpt.py``) as an ``nn.Module``.

The model ``generate_depth --model midas`` runs: a timm ViT-L/16 (absolute
position embedding, no LayerScale, no relative bias), tapped at blocks
(5, 11, 17, 23), feeding the DPT decoder of ``models/zoedepth/dpt.py``. As
in the reference:

* images enter raw (ToTensor 0..1, no resize, no ImageNet normalization);
* the position embedding is resized bilinearly with ``align_corners=False``
  (MiDaS's ``_resize_pos_embed``), not with DINO's bicubic +0.1 quirk, so
  ``VisionTransformer.prepare_tokens`` is not used;
* taps are raw block outputs, before any norm.

The blocks are the port's ``models/vit.Block``, so attention is the Hopper
kernel without a bias on CUDA (``attn_impl="auto"``) and nothing pads the
token axis. Module names: ``pretrained.model.*`` (the DINO/timm ViT keys),
``pretrained.act_postprocess{1..4}.*`` and ``scratch.*``.
"""

from __future__ import annotations

import dataclasses

import torch

from depthg_tpu_torch.models import vit as vit_lib
from depthg_tpu_torch.models.zoedepth.dpt import DPT, DPTConfig
from depthg_tpu_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class MidasDPTConfig:
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    hooks: tuple = (5, 11, 17, 23)
    img_size: int = 384  # pos-embed table size only; inputs are flexible
    features: int = 256
    reassemble_channels: tuple = (256, 512, 1024, 1024)
    project_readout: bool = True

    @property
    def vit(self) -> vit_lib.ViTConfig:
        return vit_lib.ViTConfig(patch_size=self.patch_size, embed_dim=self.embed_dim,
                                 depth=self.depth, num_heads=self.num_heads,
                                 img_size=self.img_size)

    @property
    def dpt(self) -> DPTConfig:
        return DPTConfig(embed_dim=self.embed_dim, features=self.features,
                         reassemble_channels=self.reassemble_channels,
                         project_readout=self.project_readout)


def resize_pos_embed(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """MiDaS ``_resize_pos_embed``: bilinear, align_corners=False, the cls
    entry passed through."""
    n = pos.shape[1] - 1
    side = int(round(n ** 0.5))
    if (gh, gw) == (side, side):
        return pos
    grid = pos[:, 1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
    grid = resize_bilinear(grid, (gh, gw)).permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
    return torch.cat([pos[:, :1], grid], dim=1)


class MidasDPT(DPT):
    def __init__(self, cfg: MidasDPTConfig):
        super().__init__(vit_lib.VisionTransformer(cfg.vit), cfg.dpt)
        self.cfg = cfg

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MidasDPT":
        """``midas_dpt_init``'s distributions (the ViT's and ``dpt_init``'s)."""
        self.pretrained.model.init_weights(generator)
        self.init_decoder(generator)
        return self

    def forward(self, x: torch.Tensor, attn_impl: str = "auto"):
        """x: [B, 3, H, W] raw 0..1, H and W multiples of 16 -> (relative
        depth [B, H, W], hooks dict with the six tapped activations)."""
        ps = self.cfg.patch_size
        h, w = x.shape[-2:]
        if h % ps or w % ps:
            raise ValueError(f"input {h}x{w} is not a multiple of the patch size {ps}")
        gh, gw = h // ps, w // ps
        vit = self.pretrained.model
        tok = vit.patch_embed(x)
        tok = torch.cat([vit.cls_token.to(tok.dtype).expand(x.shape[0], 1, -1), tok], dim=1)
        tok = tok + resize_pos_embed(vit.pos_embed, gh, gw).to(tok.dtype)
        impl = vit_lib.resolve_attn_impl(attn_impl, None, x.device)
        taps = []
        for i, blk in enumerate(vit.blocks):
            tok, _, _ = blk(tok, impl)
            if i in self.cfg.hooks:
                taps.append(tok)  # raw block outputs (no norm)
        return self.decode(taps, (gh, gw))
