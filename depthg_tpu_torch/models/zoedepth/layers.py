"""Conv/deconv layers of the ZoeDepth/DPT stack (``depthg_tpu/models/zoedepth/layers.py``).

NCHW with torch's own weight layouts, which are the JAX package's too: a
convolution is ``nn.Conv2d`` (OIHW), the stride-k k x k transposed
convolution of the DPT reassembly is ``nn.ConvTranspose2d(stride=k)`` with
its [in, out, k, k] weight. ``init_uniform_`` draws the JAX package's
``conv_init`` / ``deconv_init`` distributions, uniform(+-1/sqrt(fan_in))
with fan_in = in x k x k, from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def conv2d(in_ch: int, out_ch: int, k: int, stride: int = 1, padding: int = 0,
           bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=padding, bias=bias)


def deconv_kxk(in_ch: int, out_ch: int, k: int) -> nn.ConvTranspose2d:
    """ConvTranspose2d with stride == kernel (one product + pixel shuffle)."""
    return nn.ConvTranspose2d(in_ch, out_ch, k, stride=k)


@torch.no_grad()
def init_uniform_(module: nn.Module, generator: torch.Generator) -> None:
    """Every Conv2d / ConvTranspose2d in ``module``: weight and bias
    uniform(+-1/sqrt(in x k x k))."""
    for m in module.modules():
        if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            continue
        fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
        bound = 1.0 / math.sqrt(fan_in)
        m.weight.uniform_(-bound, bound, generator=generator)
        if m.bias is not None:
            m.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def trunc_normal_(p: torch.Tensor, generator: torch.Generator) -> None:
    """torch ``trunc_normal_(std=.02)`` cut at +-2 std, as the JAX package's
    ``trunc_normal_init``."""
    nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=generator)
