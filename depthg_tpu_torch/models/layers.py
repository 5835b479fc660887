"""Layer helpers (``depthg_tpu/models/layers.py``).

``linear`` and ``conv1x1`` are ``nn.Linear`` and a 1x1 ``nn.Conv2d``, with
torch's own [out, in] weight layout (the Lightning key layout). Layer norm
computes in float32 and casts back, as the JAX package does, so a bf16
backbone normalizes at full precision. ``MultiheadAttention`` is the one
``nn.MultiheadAttention`` parameter layout of the port (ZoeDepth-NK's
router and the depth featurizer's cross-attention).

``W8A8Linear`` is the int8 backbone's linear (the JAX package's
``quantize_linear_params`` / ``_linear_w8a8``): int8 weights with one
symmetric scale per output channel, each token's activations quantized with
its own dynamic scale, an int8 x int8 -> int32 product (``torch._int_mm``),
and the rescale ``y * (s_x * s_w) + b`` in float32, returned in the input
dtype. Every scale divides by a tensor, never by a Python number: on CUDA
the latter is a multiply by the reciprocal, which can move a code whose
quotient sits at .5."""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from depthg_tpu_torch.parallel import dist
from depthg_tpu_torch.utils.profiling import counted, int8_matmul_flops


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


@functools.lru_cache(maxsize=None)
def _q127(device: torch.device) -> torch.Tensor:
    """127 as a 0-dim tensor on ``device``: the divisor of every scale."""
    with torch.inference_mode(False):
        return torch.tensor(127.0, device=device)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of each row of ``x`` (its last dim) and their
    float32 scales [..., 1]: s = max(|x|, 1e-12) / 127, codes = round(x / s),
    half to even. An all-zero row gets codes 0."""
    # |x| and its max are exact in x's dtype; x / s promotes x to float32
    s = x.abs().amax(dim=-1, keepdim=True).float().clamp_min(1e-12) / _q127(x.device)
    return torch.round(x / s).to(torch.int8), s


@counted(lambda a, w_q: int8_matmul_flops(*a.shape, w_q.shape[0]))
def int8_matmul(a: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 x [N, K] int8 (a linear's [out, in] weight) -> [M, N]
    int32 sums by ``torch._int_mm`` on ``w_q.t()``, column-major [K, N]
    (counted for ``step_flops`` as 2 M K N, padding rows excluded).
    ``_int_mm`` on CUDA needs M > 16 and K, N multiples of 8: fewer rows are
    padded with zero rows (their sums are 0 and are dropped); K or N off a
    multiple of 8 raises."""
    m, k = a.shape
    n = w_q.shape[0]
    if a.is_cuda and (k % 8 or n % 8):
        raise ValueError(f"int8 product [{m}, {k}] x [{k}, {n}]: K and N must be "
                         "multiples of 8 on CUDA")
    if m <= 16:
        pad = a.new_zeros((32, k))
        pad[:m] = a
        return torch._int_mm(pad, w_q.t())[:m]
    return torch._int_mm(a.contiguous(), w_q.t())


def linear_w8a8(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """``_linear_w8a8``: x [..., K] (any float dtype) against int8 ``w_q``
    [N, K] with float32 scales ``s_w`` [N] and bias ``b`` [N]; returns
    [..., N] in ``x.dtype``. The rescale keeps the JAX order: s_x * s_w
    first, then the product's rescale, then + b."""
    lead, k = x.shape[:-1], x.shape[-1]
    x_q, s_x = quantize_rows(x.reshape(-1, k))
    out = torch.mul(int8_matmul(x_q, w_q), s_x * s_w)  # float32(y) * (s_x * s_w)
    out += b
    return out.to(x.dtype).reshape(*lead, -1)


class W8A8Linear(nn.Module):
    """An int8 linear: buffers ``w_q`` int8 [out, in] (torch's layout),
    ``s_w`` float32 [out] and ``b`` float32 [out]. Made by
    ``quantize_linear``; it holds no parameter."""

    def __init__(self, w_q: torch.Tensor, s_w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("s_w", s_w)
        self.register_buffer("b", b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_w8a8(x, self.w_q, self.s_w, self.b)


@torch.no_grad()
def quantize_linear(lin: nn.Linear, bias: torch.Tensor | None = None) -> W8A8Linear:
    """``quantize_linear_params`` of an ``nn.Linear``: s_w = max over the
    input axis of |w| (at least 1e-12) / 127 per output channel, w_q =
    round(w / s_w) as int8, the bias (``bias`` if given, else the layer's,
    else zeros) in float32."""
    with torch.inference_mode(False):
        w = lin.weight.detach().float()
        s_w = w.abs().amax(dim=1).clamp_min(1e-12) / _q127(w.device)
        w_q = torch.round(w / s_w[:, None]).to(torch.int8)
        if bias is None:
            bias = lin.bias
        b = (torch.zeros(w.shape[0], device=w.device) if bias is None
             else bias.detach().float().clone())
        return W8A8Linear(w_q, s_w, b)


def cast_bf16(module: nn.Module) -> nn.Module:
    """Cast ``module``'s floating parameters and buffers to bf16 in place,
    except those of every ``W8A8Linear`` (its scales and bias stay float32):
    the JAX package's ``cast_tree_bf16`` of the parts around the int8
    linears."""
    for m in module.modules():
        if isinstance(m, W8A8Linear):
            continue
        for _, t in list(m.named_parameters(recurse=False)) + list(
                m.named_buffers(recurse=False)):
            if t.is_floating_point():
                t.data = t.data.to(torch.bfloat16)
    return module
