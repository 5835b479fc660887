"""Layer helpers (``depthg_tpu/models/layers.py``).

``linear`` and ``conv1x1`` are ``nn.Linear`` and a 1x1 ``nn.Conv2d``, with
torch's own [out, in] weight layout (the Lightning key layout). Layer norm
computes in float32 and casts back, as the JAX package does, so a bf16
backbone normalizes at full precision. ``MultiheadAttention`` is the one
``nn.MultiheadAttention`` parameter layout of the port (ZoeDepth-NK's
router and the depth featurizer's cross-attention). The int8 w8a8 linears
are not ported yet."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from depthg_tpu_torch.parallel import dist


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
    channels of [B, C, H, W] and scale the rest by 1 / (1 - rate). Under a
    process group the mask is drawn at the global batch and sharded
    (``parallel.dist.draw_rows``)."""
    if not enabled or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout2d needs the caller's torch.Generator")
    keep = dist.draw_rows(lambda n: torch.bernoulli(
        torch.full((n, x.shape[1]), 1.0 - rate, device=x.device), generator=generator),
        x.shape[0])
    return x * keep[:, :, None, None].to(x.dtype) / (1.0 - rate)


def dropout(x: torch.Tensor, rate: float, enabled: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """``nn.Dropout`` with the mask drawn from ``generator``: zero entries of
    ``x`` and scale the rest by 1 / (1 - rate)."""
    if not enabled or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs the caller's torch.Generator")
    keep = dist.draw_rows(lambda n: torch.bernoulli(
        torch.full((n, *x.shape[1:]), 1.0 - rate, device=x.device), generator=generator),
        x.shape[0])
    return x * keep.to(x.dtype) / (1.0 - rate)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (``in_proj_weight`` [3D, D],
    ``in_proj_bias``, ``out_proj``) on batch-first [B, S, D] inputs, eager
    softmax over float32 logits (the JAX package's ``_multihead_attention``).
    ``forward(x)`` is self-attention; ``forward(q, kv)`` attends from the
    queries ``q`` to keys and values both projected from ``kv``. With
    ``drop_rate > 0`` the attention weights take a dropout mask drawn from
    ``generator``."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(nn.init.xavier_uniform_(torch.empty(3 * d, d)))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, q: torch.Tensor, kv: torch.Tensor | None = None,
                drop_rate: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, s, d = q.shape
        h = self.num_heads
        if kv is None:
            q, k, v = (F.linear(q, self.in_proj_weight, self.in_proj_bias)
                       .view(b, s, 3, h, -1).permute(2, 0, 3, 1, 4))
        else:
            w_q, w_kv = self.in_proj_weight.split([d, 2 * d])
            b_q, b_kv = self.in_proj_bias.split([d, 2 * d])
            q = F.linear(q, w_q, b_q).view(b, s, h, -1).transpose(1, 2)
            k, v = F.linear(kv, w_kv, b_kv).view(b, -1, 2, h, d // h).permute(2, 0, 3, 1, 4)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d // h)
        attn = dropout(logits.softmax(dim=-1).to(q.dtype), drop_rate, drop_rate > 0, generator)
        out = torch.matmul(attn, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))
