"""Layer helpers (``depthg_tpu/models/layers.py``).

``linear`` and ``conv1x1`` are ``nn.Linear`` and a 1x1 ``nn.Conv2d``, with
torch's own [out, in] weight layout (the Lightning key layout). Layer norm
computes in float32 and casts back, as the JAX package does, so a bf16
backbone normalizes at full precision. The int8 w8a8 linears are not
ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in float32, returned in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def conv1x1(in_ch: int, out_ch: int) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, kernel_size=1)


def dropout2d(x: torch.Tensor, rate: float, enabled: bool,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """``nn.Dropout2d`` with the mask drawn from ``generator``: zero whole
    channels of [B, C, H, W] and scale the rest by 1 / (1 - rate)."""
    if not enabled or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout2d needs the caller's torch.Generator")
    keep = torch.bernoulli(torch.full(x.shape[:2], 1.0 - rate, device=x.device),
                           generator=generator)
    return x * keep[:, :, None, None].to(x.dtype) / (1.0 - rate)
