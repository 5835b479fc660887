"""DINO Vision Transformer (``depthg_tpu/models/vit.py``) as an ``nn.Module``.

Parameter names are the DINO/reference keys (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.i.{norm1, attn.qkv, attn.proj, norm2,
mlp.fc1, mlp.fc2}``, ``norm``), so a DINO state dict, or the JAX package's
``utils/ckpt.py:vit_state_dict`` output, loads with ``strict=True``.

Kept from the JAX version: the bicubic positional-embedding quirk
(scale = (side_px // ps + 0.1) / sqrt(N) passed as an explicit scale
factor), the ``get_intermediate_feat`` contract (normed tokens, attention
maps and qkv of the last ``n`` blocks) and ``resolve_attn_impl``. GELU is
exact erf in float32 and the tanh approximation in bf16 (the JAX package's
choice; its error is below the bf16 step).

``quantize_vit`` is the int8 backbone (``quantize_vit_params``): a copy
whose block linears (qkv, proj, fc1, fc2) are ``layers.W8A8Linear`` and
whose other parameters are bf16. ``int8_copy`` keeps one such copy per
model and derives it again when any of the model's parameters is replaced
or changed in place.

Attention: ``"xla"`` is the eager softmax that can return attention maps;
``"fused"`` / ``"flash"`` go through ``ops.attention.attention_qkv``, which
launches the Hopper kernel on CUDA tensors (one launch per layer for all
heads and images). Unlike the TPU version, nothing pads the token axis: the
kernel masks the ragged last tile itself.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import weakref

import torch
import torch.nn.functional as F
from torch import nn

from depthg_tpu_torch.models.layers import LayerNorm, cast_bf16, quantize_linear
from depthg_tpu_torch.ops.attention import attention_qkv
from depthg_tpu_torch.ops.resize import resize_bicubic


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 8
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    img_size: int = 224  # only fixes the size of the learned pos_embed table


VIT_PRESETS = {
    "vit_tiny": dict(embed_dim=192, depth=12, num_heads=3),
    "vit_small": dict(embed_dim=384, depth=12, num_heads=6),
    "vit_base": dict(embed_dim=768, depth=12, num_heads=12),
}


def make_config(arch: str, patch_size: int) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, **VIT_PRESETS[arch])


def resolve_attn_impl(impl: str, precision: str | None, device: torch.device,
                      need_attn: bool = False) -> str:
    """"auto" -> "fused" (the Hopper kernel) on CUDA unless a parity
    precision is requested or the attention maps are consumed
    (``need_attn``: LHP's attention propagation); "xla" (eager, returns
    attention maps) otherwise, and always on the CPU. A kernel path that
    is forced while the maps are needed raises."""
    if impl != "auto":
        if impl in ("flash", "fused") and need_attn:
            raise ValueError(
                f"attention_impl='{impl}' cannot return attention maps, but "
                "this configuration consumes them (LHP attn propagation): "
                "use 'auto' or 'xla'")
        return impl
    if need_attn or precision is not None or device.type != "cuda":
        return "xla"
    return "fused"


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)  # [B, Hp*Wp, D]


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.scale = (d // cfg.num_heads) ** -0.5
        self.qkv = nn.Linear(d, 3 * d, bias=cfg.qkv_bias)
        self.proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, impl: str = "xla"):
        """Returns (output [B, N, D], attn [B, h, N, N] or None, qkv [B, N, 3D])."""
        b, n, d = x.shape
        qkv = self.qkv(x)
        if impl in ("fused", "flash"):
            return self.proj(attention_qkv(qkv, self.num_heads, self.scale)), None, qkv
        if impl != "xla":
            raise ValueError(f"unknown attention impl {impl!r}")
        q, k, v = qkv.view(b, n, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.scale
        attn = logits.softmax(dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, d)
        return self.proj(out), attn, qkv


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.embed_dim, hidden)
        self.fc2 = nn.Linear(hidden, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        approx = "tanh" if x.dtype == torch.bfloat16 else "none"
        return self.fc2(F.gelu(self.fc1(x), approximate=approx))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.norm2 = LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg)

    def forward(self, x: torch.Tensor, impl: str = "xla"):
        y, attn, qkv = self.attn(self.norm1(x), impl)
        x = x + y
        return x + self.mlp(self.norm2(x)), attn, qkv


def interpolate_pos_encoding(pos_embed: torch.Tensor, npatch: int, w: int,
                             h: int, ps: int) -> torch.Tensor:
    """Bicubic pos-embed resize for any input size, with the reference's
    +0.1 scale-factor fudge (``w``/``h`` are the true image width/height)."""
    n = pos_embed.shape[1] - 1
    if npatch == n and w == h:
        return pos_embed
    dim = pos_embed.shape[-1]
    side = int(math.sqrt(n))
    patch_pos = pos_embed[:, 1:].reshape(1, side, side, dim).permute(0, 3, 1, 2)
    sf = ((h // ps + 0.1) / side, (w // ps + 0.1) / side)  # (H, W) factors
    out_hw = (int(side * sf[0]), int(side * sf[1]))
    patch_pos = resize_bicubic(patch_pos, out_hw, scale=sf)
    patch_pos = patch_pos.permute(0, 2, 3, 1).reshape(1, -1, dim)
    return torch.cat([pos_embed[:, :1], patch_pos], dim=1)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        n_tok = (cfg.img_size // cfg.patch_size) ** 2 + 1
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tok, cfg.embed_dim))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)

    def init_weights(self, generator: torch.Generator) -> "VisionTransformer":
        """DINO's init: trunc_normal(std .02) weights and tokens, zero
        biases, unit layer norms (for random-weight runs: no checkpoint is
        needed to drive the full-width model)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias") or ".norm" in name or name.startswith("norm"):
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                else:
                    nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                          generator=generator)
        return self

    def prepare_tokens(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        tok = self.patch_embed(x)
        cls = self.cls_token.to(tok.dtype).expand(b, 1, -1)
        tok = torch.cat([cls, tok], dim=1)
        pos = interpolate_pos_encoding(self.pos_embed, tok.shape[1] - 1, w, h,
                                       self.cfg.patch_size)
        return tok + pos.to(tok.dtype)

    def forward(self, x: torch.Tensor, n: int = 1, attn_impl: str = "xla"):
        """``get_intermediate_feat``: (feats, attns, qkvs) of the last ``n``
        blocks — post-norm tokens [B, N, D], attention maps (None under the
        kernel) and qkv as [3, B, h, N, hd] views of the projection output."""
        x = self.prepare_tokens(x)
        feats, attns, qkvs = [], [], []
        depth = len(self.blocks)
        for i, blk in enumerate(self.blocks):
            x, attn, qkv = blk(x, attn_impl)
            if depth - i <= n:
                b, t, _ = qkv.shape
                feats.append(self.norm(x))
                attns.append(attn)
                qkvs.append(qkv.view(b, t, 3, self.cfg.num_heads, -1)
                            .permute(2, 0, 3, 1, 4))
        return feats, attns, qkvs


@torch.no_grad()
def quantize_vit(model: VisionTransformer) -> VisionTransformer:
    """The int8 (w8a8) copy of ``model``: every block's ``attn.qkv``,
    ``attn.proj``, ``mlp.fc1`` and ``mlp.fc2`` becomes a ``W8A8Linear``
    quantized from the float32 weights; the patch embedding, tokens,
    position table and norms are cast to bf16. The model is not changed."""
    with torch.inference_mode(False):
        out = copy.deepcopy(model).requires_grad_(False)
        for blk in out.blocks:
            blk.attn.qkv = quantize_linear(blk.attn.qkv)
            blk.attn.proj = quantize_linear(blk.attn.proj)
            blk.mlp.fc1 = quantize_linear(blk.mlp.fc1)
            blk.mlp.fc2 = quantize_linear(blk.mlp.fc2)
        return cast_bf16(out)


_INT8_COPIES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _weights_key(model: nn.Module) -> tuple:
    return tuple((p.data_ptr(), p._version, p.device) for p in model.parameters())


def int8_copy(model: VisionTransformer) -> VisionTransformer:
    """``quantize_vit(model)``, derived once per set of weights: the copy is
    kept with the storage and version counter of every parameter of
    ``model``, so a load, a move or an in-place update derives it again
    (and frees the older copy first)."""
    key = _weights_key(model)
    hit = _INT8_COPIES.get(model)
    if hit is not None and hit[0] == key:
        return hit[1]
    _INT8_COPIES.pop(model, None)
    quantized = quantize_vit(model)
    _INT8_COPIES[model] = (key, quantized)
    return quantized
