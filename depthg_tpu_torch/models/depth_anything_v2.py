"""Depth Anything V2 (arXiv:2406.09414) as an ``nn.Module``: the model
``generate_depth --model depth_anything_v2`` runs.

Written from the published code (github.com/DepthAnything/Depth-Anything-V2:
``depth_anything_v2/dpt.py`` ``DepthAnythingV2`` and ``DPTHead``,
``depth_anything_v2/dinov2.py``, ``util/blocks.py``), at ``run.py``'s
``model_configs['vitl']``:

* the image in [0, 1] is normalized on the device with ImageNet's mean and
  std;
* the encoder is the ``dinov2_vitl14`` preset of ``models/vit.py`` (24
  LayerScale blocks 1024 wide, 16 heads of 64, the 37 x 37 table resized
  bicubically by DINO's +0.1 scale factor), tapped after blocks
  (4, 11, 17, 23) through its final norm with the class token dropped
  (``VisionTransformer.normed_taps``: DINOv2's ``get_intermediate_layers``);
* the decoder is ``models/zoedepth/dpt.py``'s with no readout (the taps
  come without the class token: the published ``use_clstoken`` False; its
  readout projection is not ported), 1x1 projections to
  (256, 512, 1024, 1024), the x4 and x2 transposed convolutions, the
  identity and the stride-2 3x3 convolution, the ``layer{i}_rn``
  convolutions and four ``FeatureFusionBlock``s; its head's resize goes to
  the input size (14 x the patch grid), not to twice the finest map as
  MiDaS's does, and ends in the ReLU that gives the relative disparity.

Attention goes through ``attention_qkv`` (the Hopper kernel without a bias
on CUDA, one launch a block: 24 a forward). GELU is exact in float32 and
the tanh approximation in bf16, as everywhere in ``models/vit.py``; the
published model's is exact.

``forward`` opens the spans ``backbone`` (the normalization, the ViT and its
four normed taps), ``dpt`` (reassembly through ``refinenet1``) and
``out_head`` (``output_conv1``, the resize to the input size,
``output_conv2`` and its ReLUs) of ``utils.profiling``.

Module names are the port's DPT layout (``pretrained.model.*`` for the ViT,
``pretrained.act_postprocess{1..4}.{3,4}``, ``scratch.*``);
``models/zoedepth/convert.py`` maps the released file's names
(``pretrained.*``, ``depth_head.*``) onto them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from depthg_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from depthg_tpu_torch.models import vit as vit_lib
from depthg_tpu_torch.models.zoedepth.dpt import DPT, DPTConfig
from depthg_tpu_torch.utils import profiling

@dataclasses.dataclass(frozen=True)
class DepthAnythingV2Config:
    vit: vit_lib.ViTConfig = dataclasses.field(
        default_factory=lambda: vit_lib.make_config("dinov2_vitl14", 14))
    hooks: tuple = (4, 11, 17, 23)
    features: int = 256
    out_channels: tuple = (256, 512, 1024, 1024)
    # the input rule (``image2tensor``'s ``Resize``): 518 x 518 as a lower
    # bound, aspect kept, each side a multiple of the patch size
    img_size: tuple = (518, 518)

    @property
    def dpt(self) -> DPTConfig:
        return DPTConfig(embed_dim=self.vit.embed_dim, features=self.features,
                         reassemble_channels=self.out_channels, project_readout=False)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """ImageNet's (x - mean) / std per channel of [B, 3, H, W], in float32,
    with the constants as scalars (no host-to-device copy a call)."""
    x = x.float()
    return torch.cat([(x[:, c:c + 1] - float(m)) / float(s)
                      for c, (m, s) in enumerate(zip(IMAGENET_MEAN, IMAGENET_STD))], 1)


class DepthAnythingV2(DPT):
    def __init__(self, cfg: DepthAnythingV2Config):
        super().__init__(vit_lib.VisionTransformer(cfg.vit), cfg.dpt)
        for i in range(4):  # the taps arrive without the class token
            getattr(self.pretrained, f"act_postprocess{i + 1}")[0] = nn.Identity()
        self.cfg = cfg

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DepthAnythingV2":
        """The ViT's init (DINO's, LayerScale at DINOv2's 1e-5) and
        ``dpt_init``'s uniform convolutions, the last one's bias at 2 (the
        value of the benchmark configuration's ``init.out_bias``): at a
        bias of 0 the final ReLU zeroes every pixel of the uniform init,
        and a random run would write constant maps."""
        self.pretrained.model.init_weights(generator)
        self.init_decoder(generator)
        self.scratch.output_conv[4].bias.fill_(2.0)
        return self

    def forward(self, x: torch.Tensor, attn_impl: str = "auto"):
        """x: [B, 3, H, W] in [0, 1], H and W multiples of 14 -> (relative
        disparity [B, H, W], hooks: ``l4_rn``, ``r4``..``r1`` and
        ``out_conv``, the 32-channel activation before the last 1x1)."""
        ps = self.cfg.vit.patch_size
        h, w = x.shape[-2:]
        if h % ps or w % ps:
            raise ValueError(f"input {h}x{w} is not a multiple of the patch size {ps}")
        vit = self.pretrained.model
        impl = vit_lib.resolve_attn_impl(attn_impl, None, x.device)
        with profiling.span("backbone"):
            x = normalize(x).to(vit.cls_token.dtype)
            taps = vit.normed_taps(x, self.cfg.hooks, impl)
        with profiling.span("dpt"):
            p1, hooks = self.fuse(taps, (h // ps, w // ps))
        with profiling.span("out_head"):
            return self.head(p1, hooks, (h, w))
