"""Operations and bounds of a DINOv2 eval step, the yardstick of `mfu.eval`
and `k1_roofline_pct.eval` in the DINOv2 cell: counted from the
configuration's published widths, never from the code that runs (the
attention's count and bound are `benchmark.counting`'s).

Per image and block: the four linears (qkv D -> 3D, proj D -> D, the
SwiGLU's w12 D -> 2H and w3 H -> D) over every token (class token, the
registers and the patches) and the attention over every token; the patch
embedding once. The SwiGLU gate, the LayerScale products, the layer norms
and the residual adds are element-wise and not counted, as no GELU or norm
is in `benchmark.counting`. The head and probes are `benchmark.counting`'s.
"""

from __future__ import annotations

from benchmark.counting import attention_bound_s, attention_flops, head_flops, probe_flops


def tokens(bb: dict, res: int) -> int:
    """The class token, the registers and the patches of a square image."""
    return 1 + bb["n_registers"] + (res // bb["patch_size"]) ** 2


def vit_flops(bb: dict, res: int) -> float:
    """One image through the DINOv2 ViT."""
    d, p, hidden = bb["embed_dim"], bb["patch_size"], bb["ffn_hidden"]
    t = tokens(bb, res)
    patch_embed = 2.0 * (res // p) ** 2 * 3 * p * p * d
    linears = 2.0 * t * d * (3 * d + d + 2 * hidden + hidden)
    attn = attention_flops(1, bb["num_heads"], t, t, bb["head_dim"])
    return patch_embed + bb["depth"] * (linears + attn)


def swiglu_flops(bb: dict, res: int) -> float:
    """One image's SwiGLU products (w12 and w3) over every block."""
    return bb["depth"] * 2.0 * tokens(bb, res) * bb["embed_dim"] * 3 * bb["ffn_hidden"]


def eval_step_flops(cfg: dict, batch: int) -> float:
    """Model work of one eval step: both flip-TTA passes through the ViT and
    the head, then the probes once on the averaged code. The CRF is not
    counted (its share shows in the trace's breakdown)."""
    res = cfg["eval"]["res"]
    passes = 2 if cfg["eval"]["flip_tta"] else 1
    per_image = passes * (vit_flops(cfg["backbone"], res) + head_flops(cfg, res)) \
        + probe_flops(cfg, res)
    return batch * per_image


def eval_attention_bound_s(cfg: dict, batch: int) -> float:
    """Least seconds of one eval step's attention: per block one call over
    both flip-TTA passes of the batch."""
    bb = cfg["backbone"]
    passes = 2 if cfg["eval"]["flip_tta"] else 1
    t = tokens(bb, cfg["eval"]["res"])
    return bb["depth"] * attention_bound_s(passes * batch, t, bb["num_heads"], bb["head_dim"])
