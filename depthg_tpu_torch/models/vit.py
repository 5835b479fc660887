"""DINO Vision Transformer (``depthg_tpu/models/vit.py``) as an ``nn.Module``.

Parameter names are the DINO/reference keys (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.i.{norm1, attn.qkv, attn.proj, norm2,
mlp.fc1, mlp.fc2}``, ``norm``), so a DINO state dict, or the JAX package's
``utils/ckpt.py:vit_state_dict`` output, loads with ``strict=True``.

The ``dinov2_vitg14_reg`` preset is DINOv2's ViT-g/14 with registers
(arXiv:2304.07193, arXiv:2309.16588; ``dinov2/models/vision_transformer.py``
``vit_giant2`` as ``dinov2/hub/backbones.py`` builds it), under the hub's
keys: ``register_tokens`` inserted after the class token (after the
position table is added), ``blocks.i.ls1.gamma`` / ``ls2.gamma``
(LayerScale on both residual branches, ``LayerScaleBlock``), a SwiGLU
feed-forward ``blocks.i.mlp.{w12, w3}`` (``SwiGLUFFNFused``: hidden
(int(4 D 2/3) + 7) // 8 * 8, one ``swiglu`` span each) and the position
table resized bicubically to the grid by size, antialiased. The DINO v1
presets build ``Block`` and ``Mlp`` and insert no token: their forward
launches what it did before the DINOv2 parts existed. The ``dinov2_vitl14``
preset is the ViT-L/14 that Depth Anything V2 vendors (``vit_large``:
LayerScale, the GELU ``Mlp``, no registers, DINO's +0.1 table resize
without antialias); ``normed_taps`` is its ``get_intermediate_layers``.

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
from depthg_tpu_torch.ops.swiglu import swiglu_gate
from depthg_tpu_torch.utils import profiling


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
    # DINOv2's parts; the defaults are DINO v1's
    n_registers: int = 0       # register tokens after the class token
    layer_scale: bool = False  # ls1 / ls2 on the residual branches
    ffn: str = "mlp"           # "mlp" (fc1, GELU, fc2) | "swiglu" (w12, SiLU gate, w3)
    pos_resize: str = "dino"   # "dino" (+0.1 scale factor) | "dinov2" (by size, antialiased)

    @property
    def n_prefix(self) -> int:
        """Tokens before the patches: the class token and the registers."""
        return 1 + self.n_registers


VIT_PRESETS = {
    "vit_tiny": dict(embed_dim=192, depth=12, num_heads=3),
    "vit_small": dict(embed_dim=384, depth=12, num_heads=6),
    "vit_base": dict(embed_dim=768, depth=12, num_heads=12),
    # the hub's dinov2_vitg14_reg: vit_giant2, 518-px pretraining (a 37 x 37 table)
    "dinov2_vitg14_reg": dict(patch_size=14, embed_dim=1536, depth=40, num_heads=24,
                              img_size=518, n_registers=4, layer_scale=True, ffn="swiglu",
                              pos_resize="dinov2"),
    # Depth Anything V2's vendored ViT-L/14 (``depth_anything_v2/dinov2.py`` vit_large):
    # 518-px table, LayerScale, GELU MLP, no registers, interpolate_offset 0.1
    # without antialias, which is DINO's resize ("dino")
    "dinov2_vitl14": dict(patch_size=14, embed_dim=1024, depth=24, num_heads=16, img_size=518,
                          layer_scale=True, pos_resize="dino"),
}


def make_config(arch: str, patch_size: int) -> ViTConfig:
    """The preset ``arch`` at ``patch_size``; a preset that fixes its patch
    size (DINOv2's 14) refuses any other."""
    preset = VIT_PRESETS[arch]
    if preset.get("patch_size", patch_size) != patch_size:
        raise ValueError(f"{arch} has patch size {preset['patch_size']}; got "
                         f"dino_patch_size={patch_size}")
    return ViTConfig(**{"patch_size": patch_size, **preset})


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


def swiglu_hidden(cfg: ViTConfig) -> int:
    """``SwiGLUFFNFused``'s hidden width: (int(D ratio 2/3) + 7) // 8 * 8."""
    return (int(int(cfg.embed_dim * cfg.mlp_ratio) * 2 / 3) + 7) // 8 * 8


class SwiGLU(nn.Module):
    """DINOv2's ``SwiGLUFFNFused``: w3(silu(a) * b), [a, b] = chunk(w12(x), 2),
    the gate through ``ops.swiglu.swiglu_gate`` (one kernel launch on CUDA);
    one ``swiglu`` span (``utils.profiling``)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        hidden = swiglu_hidden(cfg)
        self.w12 = nn.Linear(cfg.embed_dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with profiling.span("swiglu"):
            return self.w3(swiglu_gate(self.w12(x)))


class LayerScale(nn.Module):
    """x * gamma, a learned scale per channel (DINOv2's ``LayerScale``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.norm2 = LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.mlp = SwiGLU(cfg) if cfg.ffn == "swiglu" else Mlp(cfg)

    def forward(self, x: torch.Tensor, impl: str = "xla"):
        y, attn, qkv = self.attn(self.norm1(x), impl)
        x = x + y
        return x + self.mlp(self.norm2(x)), attn, qkv


class LayerScaleBlock(Block):
    """DINOv2's block: x + ls1(attn(norm1(x))), then x + ls2(mlp(norm2(x)))."""

    def __init__(self, cfg: ViTConfig):
        super().__init__(cfg)
        self.ls1 = LayerScale(cfg.embed_dim)
        self.ls2 = LayerScale(cfg.embed_dim)

    def forward(self, x: torch.Tensor, impl: str = "xla"):
        y, attn, qkv = self.attn(self.norm1(x), impl)
        x = x + self.ls1(y)
        return x + self.ls2(self.mlp(self.norm2(x))), attn, qkv


def interpolate_pos_encoding(pos_embed: torch.Tensor, npatch: int, w: int,
                             h: int, ps: int, mode: str = "dino") -> torch.Tensor:
    """Bicubic pos-embed resize for any input size (``w``/``h`` are the
    true image width/height), skipped for a square image at the table's own
    grid. ``mode="dino"``: the reference's +0.1 scale-factor fudge;
    ``"dinov2"``: DINOv2's, to the grid by size, antialiased (its
    ``interpolate_offset`` 0, ``interpolate_antialias``)."""
    n = pos_embed.shape[1] - 1
    if npatch == n and w == h:
        return pos_embed
    dim = pos_embed.shape[-1]
    side = int(math.sqrt(n))
    patch_pos = pos_embed[:, 1:].reshape(1, side, side, dim).permute(0, 3, 1, 2)
    if mode == "dinov2":
        patch_pos = resize_bicubic(patch_pos, (h // ps, w // ps), antialias=True)
    else:
        sf = ((h // ps + 0.1) / side, (w // ps + 0.1) / side)  # (H, W) factors
        out_hw = (int(side * sf[0]), int(side * sf[1]))
        patch_pos = resize_bicubic(patch_pos, out_hw, scale=sf)
    patch_pos = patch_pos.permute(0, 2, 3, 1).reshape(1, -1, dim)
    return torch.cat([pos_embed[:, :1], patch_pos], dim=1)


# DINOv2's LayerScale init for training (``dinov2/configs/ssl_default_config.yaml``
# ``student.layerscale``; the hub builds its backbones with ``init_values`` 1.0
# and loads the trained gammas over it)
LAYER_SCALE_INIT = 1e-5


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        n_tok = (cfg.img_size // cfg.patch_size) ** 2 + 1
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tok, cfg.embed_dim))
        self.register_parameter("register_tokens", nn.Parameter(
            torch.zeros(1, cfg.n_registers, cfg.embed_dim)) if cfg.n_registers else None)
        block = LayerScaleBlock if cfg.layer_scale else Block
        self.blocks = nn.ModuleList(block(cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)

    def init_weights(self, generator: torch.Generator) -> "VisionTransformer":
        """DINO's init: trunc_normal(std .02) weights and tokens, zero
        biases, unit layer norms (for random-weight runs: no checkpoint is
        needed to drive the full-width model); LayerScale at DINOv2's
        training init (1e-5, ``LAYER_SCALE_INIT``)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias") or ".norm" in name or name.startswith("norm"):
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                elif name.endswith(".gamma"):
                    p.fill_(LAYER_SCALE_INIT)
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
                                       self.cfg.patch_size, self.cfg.pos_resize)
        tok = tok + pos.to(tok.dtype)
        if self.register_tokens is None:
            return tok
        reg = self.register_tokens.to(tok.dtype).expand(b, -1, -1)
        return torch.cat([tok[:, :1], reg, tok[:, 1:]], dim=1)

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

    def normed_taps(self, x: torch.Tensor, blocks, attn_impl: str = "xla") -> list:
        """DINOv2's ``get_intermediate_layers(norm=True)``: for each of
        ``blocks`` (in that order, repeats allowed), that block's output
        through the final norm with the class token and registers dropped,
        [B, Hp*Wp, D]. The blocks after the last one asked for do not run."""
        x = self.prepare_tokens(x)
        normed = {}
        for i, blk in enumerate(self.blocks[:max(blocks) + 1]):
            x, _, _ = blk(x, attn_impl)
            if i in blocks:
                normed[i] = self.norm(x)[:, self.cfg.n_prefix:]
        return [normed[i] for i in blocks]


@torch.no_grad()
def quantize_vit(model: VisionTransformer) -> VisionTransformer:
    """The int8 (w8a8) copy of ``model``: every block's ``attn.qkv``,
    ``attn.proj`` and feed-forward linears (``mlp.fc1`` and ``mlp.fc2``, or
    SwiGLU's ``mlp.w12`` and ``mlp.w3``) becomes a ``W8A8Linear`` quantized
    from the float32 weights; the patch embedding, tokens, position table,
    LayerScale gammas and norms are cast to bf16. The model is not changed."""
    with torch.inference_mode(False):
        out = copy.deepcopy(model).requires_grad_(False)
        for blk in out.blocks:
            blk.attn.qkv = quantize_linear(blk.attn.qkv)
            blk.attn.proj = quantize_linear(blk.attn.proj)
            for name, lin in list(blk.mlp.named_children()):
                setattr(blk.mlp, name, quantize_linear(lin))
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
