"""BEiT-Large backbone of ZoeDepth (``depthg_tpu/models/zoedepth/beit.py``) as an ``nn.Module``.

timm ``beit_large_patch16_384`` with MiDaS 3.1's arbitrary-resolution
adaptation: patch-16 embedding, cls token, no absolute position embedding,
24 pre-norm blocks with LayerScale (``gamma_1``/``gamma_2``) and the
decomposed qkv bias ``cat(q_bias, 0, v_bias)``, and per block a relative
position bias over the (patches + cls) window, whose 2-D table is resized
bilinearly (``align_corners=False``, MiDaS 3.1's ``_get_rel_pos_bias``) for
any window other than the pretraining one. (``BEiTConfig.rel_pos_resize =
"bicubic"`` resizes it as the JAX package does, a departure from the
published model.) Parameter names are timm's, so ``core.core.pretrained.model.*`` of a
released ZoeDepth file loads with ``strict=True``.

The bias of a block is built once per input size and kept with its table
(``models/frozen_cache.py``; inference only: with gradients on it is
rebuilt every call), as
[heads, N, round_up(N, 8)] storage whose [:, :, :N] view goes to the
attention kernel, which reads bias rows in aligned pairs. A bias built
without gradients is counted by ``frozen_cache``'s builds.

Attention (the ``attn_impl`` argument of the forward, by default
``BEiTConfig.attn_impl``, ``"auto"``): ``"xla"`` is the eager softmax of the
JAX package's einsum path (float32 logits x scale + bias, softmax cast to
the input dtype, product with v); ``"fused"`` goes through
``ops.attention.attention_qkv(..., bias=)``, the Hopper kernel on CUDA,
which follows ``_attend``'s contract (q x scale rounded to the input dtype
first); ``"auto"`` is fused on CUDA and xla on the CPU. (The JAX package's
default is ``"xla"``; the port's is ``"auto"``, so a model on the card runs
the kernel unless told otherwise.) The token axis is
not padded: the kernel takes any N. The MLP uses the exact GELU in every
dtype (unlike the DINO ViT's tanh form in bf16).

``quantize_beit`` is the int8 backbone (``quantize_beit_params``): a copy
whose block linears are ``layers.W8A8Linear``, the decomposed qkv bias
``cat(q_bias, 0, v_bias)`` folded into the quantized qkv's float32 bias,
and every other parameter in bf16.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from depthg_tpu_torch.models import frozen_cache
from depthg_tpu_torch.models.layers import LayerNorm, W8A8Linear, cast_bf16, quantize_linear
from depthg_tpu_torch.models.vit import resolve_attn_impl
from depthg_tpu_torch.models.zoedepth.layers import trunc_normal_
from depthg_tpu_torch.ops.attention import attention_qkv
from depthg_tpu_torch.ops.resize import resize_bicubic, resize_bilinear


@dataclasses.dataclass(frozen=True)
class BEiTConfig:
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    pretrain_window: int = 24  # 384 / 16
    hooks: tuple = (5, 11, 17, 23)
    layer_scale_init: float = 1e-5
    attn_impl: str = "auto"  # "auto" | "xla" | "fused"
    # the relative-position table's resize to a window other than the
    # pretraining one: "bilinear" (MiDaS 3.1, the released model) | "bicubic"
    rel_pos_resize: str = "bilinear"


@functools.lru_cache(maxsize=None)
def relative_position_index(h: int, w: int) -> np.ndarray:
    """timm BEiT relative_position_index for an (h*w + 1)-token window."""
    num_rel = (2 * h - 1) * (2 * w - 1)
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, N, N]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    n = h * w
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    # timm order: the 3 special entries at the END of the table are
    # (cls-to-token, token-to-cls, cls-to-cls)
    idx[0, 0:] = num_rel
    idx[0:, 0] = num_rel + 1
    idx[0, 0] = num_rel + 2
    return idx


def relative_position_bias(table: torch.Tensor, window: int, h: int, w: int,
                           resize: str = "bilinear") -> torch.Tensor:
    """[heads, N, N] bias (N = h w + 1) in the table's dtype for an h x w
    patch window, resizing the 2-D part of the table (``resize``:
    "bilinear" or "bicubic", in float32) when the window is not ``window`` x
    ``window``. The result is the [:, :, :N] view of [heads, N,
    round_up(N, 8)] storage."""
    if (h, w) != (window, window):
        resize_fn = {"bilinear": resize_bilinear, "bicubic": resize_bicubic}[resize]
        grid = table[:-3].reshape(2 * window - 1, 2 * window - 1, -1).permute(2, 0, 1)
        grid = resize_fn(grid[None].float(), (2 * h - 1, 2 * w - 1))[0]
        grid = grid.permute(1, 2, 0).reshape(-1, table.shape[-1])
        table = torch.cat([grid.to(table.dtype), table[-3:]], dim=0)
    idx = torch.from_numpy(relative_position_index(h, w)).to(table.device)
    n = idx.shape[0]
    out = table.new_zeros(table.shape[-1], n, -(-n // 8) * 8)
    out[:, :, :n] = table[idx].permute(2, 0, 1)
    return out[:, :, :n]


class PatchEmbed(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)  # [B, h*w, D]


class Attention(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        d, nh = cfg.embed_dim, cfg.num_heads
        self.num_heads = nh
        self.scale = (d // nh) ** -0.5
        self.window = cfg.pretrain_window
        self.resize = cfg.rel_pos_resize
        self.qkv = nn.Linear(d, 3 * d, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(d))
        self.v_bias = nn.Parameter(torch.zeros(d))
        self.proj = nn.Linear(d, d)
        n_rel = (2 * cfg.pretrain_window - 1) ** 2 + 3
        self.relative_position_bias_table = nn.Parameter(torch.zeros(n_rel, nh))

    def rel_pos_bias(self, h: int, w: int) -> torch.Tensor:
        """This block's [heads, N, N] bias for an h x w window; kept with
        the table per size while gradients are off (``frozen_cache``: a load
        or an in-place update rebuilds it and drops the older ones)."""
        table = self.relative_position_bias_table

        def build():
            return relative_position_bias(table, self.window, h, w, self.resize)

        if torch.is_grad_enabled():
            return build()
        return frozen_cache.derived(table, ("rel_bias", h, w), (table,), build)

    def forward(self, x: torch.Tensor, h: int, w: int, impl: str) -> torch.Tensor:
        b, n, d = x.shape
        if isinstance(self.qkv, W8A8Linear):  # int8: the qkv bias is folded in
            qkv = self.qkv(x)
        else:
            qkv_bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
            qkv = F.linear(x, self.qkv.weight, qkv_bias)  # [B, N, 3D]
        bias = self.rel_pos_bias(h, w)
        if impl == "fused":
            out = attention_qkv(qkv, self.num_heads, self.scale, bias=bias)
        elif impl == "xla":
            q, k, v = qkv.view(b, n, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.scale
            attn = (logits + bias.float()).softmax(dim=-1).to(x.dtype)
            out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, d)
        else:
            raise ValueError(f"unknown attention impl {impl!r}")
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.embed_dim, hidden)
        self.fc2 = nn.Linear(hidden, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # exact GELU in every dtype


class Block(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = LayerNorm(d, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.norm2 = LayerNorm(d, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg)
        self.gamma_1 = nn.Parameter(torch.full((d,), cfg.layer_scale_init))
        self.gamma_2 = nn.Parameter(torch.full((d,), cfg.layer_scale_init))

    def forward(self, x: torch.Tensor, h: int, w: int, impl: str) -> torch.Tensor:
        x = x + self.gamma_1 * self.attn(self.norm1(x), h, w, impl)
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class BEiT(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BEiT":
        """``beit_init``'s distributions: trunc_normal(.02) for the patch
        embedding, cls token, linear weights and the bias tables; zero
        biases; unit norms; LayerScale at ``layer_scale_init``."""
        for name, p in self.named_parameters():
            if name.endswith(("gamma_1", "gamma_2")):
                p.fill_(self.cfg.layer_scale_init)
            elif ".norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith(("bias", "q_bias", "v_bias")):
                p.zero_()
            else:
                trunc_normal_(p, generator)
        return self

    def forward(self, x: torch.Tensor, attn_impl: str | None = None):
        """x: [B, 3, H, W] (H, W multiples of 16) -> (hook taps [B, 1+N, D]
        at ``cfg.hooks`` block outputs, (h, w) patch grid)."""
        ps = self.cfg.patch_size
        h, w = x.shape[-2] // ps, x.shape[-1] // ps
        tok = self.patch_embed(x)
        tok = torch.cat([self.cls_token.to(tok.dtype).expand(x.shape[0], 1, -1), tok], dim=1)
        impl = resolve_attn_impl(attn_impl or self.cfg.attn_impl, None, x.device)
        taps = []
        for i, blk in enumerate(self.blocks):
            tok = blk(tok, h, w, impl)
            if i in self.cfg.hooks:
                taps.append(tok)
        return taps, (h, w)


@torch.no_grad()
def quantize_beit(model: BEiT) -> BEiT:
    """The int8 (w8a8) copy of ``model``: each block's packed qkv (its bias
    ``cat(q_bias, 0, v_bias)`` folded in, ``q_bias`` / ``v_bias`` dropped),
    ``attn.proj``, ``mlp.fc1`` and ``mlp.fc2`` become ``W8A8Linear``s
    quantized from the float32 weights; norms, LayerScale gammas, the bias
    tables, the patch embedding and the cls token are cast to bf16. The
    model is not changed."""
    with torch.inference_mode(False):
        out = copy.deepcopy(model).requires_grad_(False)
        for blk in out.blocks:
            attn = blk.attn
            qkv_bias = torch.cat([attn.q_bias, torch.zeros_like(attn.q_bias), attn.v_bias])
            attn.qkv = quantize_linear(attn.qkv, bias=qkv_bias)
            attn.q_bias = attn.v_bias = None
            attn.proj = quantize_linear(attn.proj)
            blk.mlp.fc1 = quantize_linear(blk.mlp.fc1)
            blk.mlp.fc2 = quantize_linear(blk.mlp.fc2)
        return cast_bf16(out)
