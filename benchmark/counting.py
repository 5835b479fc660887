"""Operations, bytes and published peaks: the yardstick of the `mfu.*` and
roofline metrics. Everything is counted from a configuration's published
shapes, never from the code that runs, so a change to the implementation
moves the time and not the count.

Copied formulas: `attention_flops` from the port's `utils/profiling.py`
and the attention bound of `chip_smoke.py` (`attention_bound`), with the
NVIDIA H100 SXM data sheet's dense peaks.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def attention_flops(b: int, h: int, n: int, n_valid: int, d: int = 64) -> float:
    """Masked attention on [B, H, N, D]: q k^T and P v over the keys that
    weigh, 2 N n_valid D operations each per (image, head)."""
    return 4.0 * b * h * n * n_valid * d


def attention_bound_s(b: int, n: int, h: int, d: int = 64, itemsize: int = 2) -> float:
    """Least seconds of one bf16 attention call: q, k, v read and o written
    once over the memory rate, or its operations at the bf16 peak,
    whichever is larger."""
    bytes_s = 4 * b * h * n * d * itemsize / PEAK_HBM_BYTES
    return max(bytes_s, attention_flops(b, h, n, n, d) / PEAK_BF16_FLOPS)


def tokens(res: int, patch: int) -> int:
    """Patch tokens plus the class token of a square image."""
    return (res // patch) ** 2 + 1


def vit_flops(bb: dict, res: int) -> float:
    """One image through the ViT: the patch embedding, and per block the
    four linears (qkv, proj, fc1, fc2) and the attention over every token."""
    d, p = bb["embed_dim"], bb["patch_size"]
    t = tokens(res, p)
    hidden = int(d * bb["mlp_ratio"])
    patch_embed = 2.0 * (t - 1) * 3 * p * p * d
    linears = 2.0 * t * d * (3 * d + d + hidden + hidden)
    attn = attention_flops(1, bb["num_heads"], t, t, bb["head_dim"])
    return patch_embed + bb["depth"] * (linears + attn)


def head_flops(cfg: dict, res: int) -> float:
    """The projection head on one image's patch features: cluster1 (a 1x1
    conv D -> dim) and the nonlinear cluster2 (D -> D -> dim)."""
    d, dim = cfg["backbone"]["embed_dim"], cfg["head"]["dim"]
    n = (res // cfg["backbone"]["patch_size"]) ** 2
    return 2.0 * n * d * dim + 2.0 * n * d * d + 2.0 * n * d * dim


def probe_flops(cfg: dict, res: int) -> float:
    """Linear probe and cluster inner products at the code's resolution."""
    dim, k = cfg["head"]["dim"], cfg["n_classes"] + cfg["extra_clusters"]
    n = (res // cfg["backbone"]["patch_size"]) ** 2
    return 2.0 * n * dim * cfg["n_classes"] + 2.0 * n * dim * k


def eval_step_flops(cfg: dict, batch: int) -> float:
    """Model work of one eval step: both flip-TTA passes through the ViT and
    the head, then the probes once on the averaged code. The CRF is not
    counted (its share shows in the trace's breakdown)."""
    res = cfg["eval"]["res"]
    passes = 2 if cfg["eval"]["flip_tta"] else 1
    per_image = passes * (vit_flops(cfg["backbone"], res) + head_flops(cfg, res)) \
        + probe_flops(cfg, res)
    return batch * per_image


def train_step_flops(cfg: dict, batch: int) -> float:
    """Model work of one train step: the frozen ViT on the image and on its
    KNN positive (forward only), the head's forward and backward on both
    (3x its forward), the probes' forward and backward on the image's code."""
    res = cfg["train"]["res"]
    per_image = 2 * vit_flops(cfg["backbone"], res) + 2 * 3 * head_flops(cfg, res) \
        + 3 * probe_flops(cfg, res)
    return batch * per_image


def eval_attention_bound_s(cfg: dict, batch: int) -> float:
    """Least seconds of one eval step's attention: per block one call over
    both flip-TTA passes of the batch (any grouping of images and passes
    gives the same operations and bytes)."""
    bb = cfg["backbone"]
    passes = 2 if cfg["eval"]["flip_tta"] else 1
    t = tokens(cfg["eval"]["res"], bb["patch_size"])
    return bb["depth"] * attention_bound_s(passes * batch, t, bb["num_heads"], bb["head_dim"])
