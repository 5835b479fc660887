"""Operations and bytes of ZoeDepth's depth step, the yardstick of
`mfu.depth` and `k1b_roofline_pct.depth`. Counted from a configuration's
published widths and the traffic's image size, never from the code that
runs: both passes (the image and its flip) of BEiT-L's patch embedding,
linears and attention, DPT's convolutions and readout linears, and the
metric-bins head's convolutions. Element-wise work, resizes, the
softmaxes and the log-binomial's exponent are not counted.
"""

from __future__ import annotations

import math

from benchmark.counting import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, attention_flops
from benchmark.reference.zoedepth import prep_size


def net_size(cfg: dict, height: int, width: int) -> tuple:
    """The network input of an image: reflect-padded by int(sqrt(side / 2)
    x 3) on each side, then MiDaS's prep resize."""
    ph = height + 2 * int(math.sqrt(height / 2) * 3)
    pw = width + 2 * int(math.sqrt(width / 2) * 3)
    return prep_size(ph, pw, cfg)


def conv_flops(area: int, cin: int, cout: int, k: int = 1) -> float:
    """A k x k convolution over ``area`` output positions (a stride-k k x k
    transposed one: over its input positions)."""
    return 2.0 * area * cin * cout * k * k


def beit_flops(cfg: dict, h: int, w: int) -> float:
    """One image through BEiT on an h x w patch grid: the patch embedding,
    and per block the four linears and the attention over every token."""
    bb = cfg["beit"]
    d, ps = bb["embed_dim"], bb["patch_size"]
    n = h * w + 1
    hidden = int(d * bb["mlp_ratio"])
    linears = 2.0 * n * d * (3 * d + d + 2 * hidden)
    attn = attention_flops(1, bb["num_heads"], n, n, bb["head_dim"])
    return conv_flops(h * w, 3, d, ps) + bb["depth"] * (linears + attn)


def _scales(h: int, w: int) -> list:
    """(rows, cols) of the four reassembled maps: 4x, 2x, 1x and 1/2 the
    patch grid (the stride-2 3x3 convolution rounds up)."""
    return [(4 * h, 4 * w), (2 * h, 2 * w), (h, w), ((h + 1) // 2, (w + 1) // 2)]


def dpt_flops(cfg: dict, h: int, w: int) -> float:
    """One image through the DPT decoder: readouts, reassembly, the
    ``layer{i}_rn`` convolutions, the four fusion blocks and the head."""
    d, dpt = cfg["beit"]["embed_dim"], cfg["dpt"]
    f, chans = dpt["features"], dpt["reassemble_channels"]
    s = [a * b for a, b in _scales(h, w)]
    hw = h * w
    total = 4 * 2.0 * hw * 2 * d * d  # the project readouts
    total += sum(conv_flops(hw, d, ch) for ch in chans)
    total += conv_flops(hw, chans[0], chans[0], 4) + conv_flops(hw, chans[1], chans[1], 2)
    total += conv_flops(s[3], chans[3], chans[3], 3)
    total += sum(conv_flops(s[i], ch, f, 3) for i, ch in enumerate(chans))
    rcu = 2 * conv_flops(1, f, f, 3)  # per position
    total += 1 * rcu * s[3] + conv_flops(s[2], f, f)  # refinenet4: one unit (no skip)
    total += 2 * rcu * s[2] + conv_flops(s[1], f, f)
    total += 2 * rcu * s[1] + conv_flops(s[0], f, f)
    total += 2 * rcu * s[0] + conv_flops(4 * s[0], f, f)
    total += conv_flops(4 * s[0], f, f // 2, 3) + conv_flops(16 * s[0], f // 2,
                                                               dpt["n_midas_out"], 3)
    return total + conv_flops(16 * s[0], dpt["n_midas_out"], 1)


def bins_flops(cfg: dict, h: int, w: int) -> float:
    """One image through the metric-bins head: ``conv2``, the seed regressor
    and projector at the bottleneck, a projector and an attractor at each
    fusion output, the log-binomial's MLP at the output."""
    dpt, bins = cfg["dpt"], cfg["bins"]
    f, emb = dpt["features"], bins["bin_embedding_dim"]
    s = [a * b for a, b in _scales(h, w)]
    pm, am = bins["projector_mlp_dim"], bins["attractor_mlp_dim"]
    total = conv_flops(s[3], f, f)
    total += conv_flops(s[3], f, bins["seed_mlp_dim"]) \
        + conv_flops(s[3], bins["seed_mlp_dim"], bins["n_bins"])
    total += conv_flops(s[3], f, pm) + conv_flops(s[3], pm, emb)
    for area, n in zip((s[2], s[1], s[0], 4 * s[0]), bins["n_attractors"]):
        total += conv_flops(area, f, pm) + conv_flops(area, pm, emb)
        total += conv_flops(area, emb, am) + conv_flops(area, am, n)
    last = dpt["n_midas_out"] + 1 + emb
    bottleneck = last // bins["log_binomial_bottleneck_factor"]
    return total + conv_flops(16 * s[0], last, bottleneck) + conv_flops(16 * s[0], bottleneck, 4)


def forward_flops(cfg: dict, hn: int, wn: int) -> float:
    """One image's ``ZoeDepth.forward`` on an hn x wn network input."""
    ps = cfg["beit"]["patch_size"]
    h, w = hn // ps, wn // ps
    return beit_flops(cfg, h, w) + dpt_flops(cfg, h, w) + bins_flops(cfg, h, w)


def passes(cfg: dict) -> int:
    return 2 if cfg["infer"]["flip_aug"] else 1


def step_flops(cfg: dict, batch: int, height: int, width: int) -> float:
    """Model work of one depth step on ``batch`` images of height x width."""
    return batch * passes(cfg) * forward_flops(cfg, *net_size(cfg, height, width))


def attention_bias_bound_s(b: int, n: int, h: int, d: int = 64, itemsize: int = 2) -> float:
    """Least seconds of one attention call with an [h, n, n] bias: q, k, v
    and the bias read and o written once over the memory rate, or its
    operations at the bf16 peak, whichever is larger."""
    bytes_s = (4 * b * h * n * d * itemsize + h * n * n * itemsize) / PEAK_HBM_BYTES
    return max(bytes_s, attention_flops(b, h, n, n, d) / PEAK_BF16_FLOPS)


def step_attention_bound_s(cfg: dict, batch: int, height: int, width: int) -> float:
    """Least seconds of one depth step's attention: one call per block and
    pass over the batch."""
    bb = cfg["beit"]
    hn, wn = net_size(cfg, height, width)
    n = (hn // bb["patch_size"]) * (wn // bb["patch_size"]) + 1
    itemsize = 2 if cfg["infer"]["dtype"] == "bfloat16" else 4
    return passes(cfg) * bb["depth"] * attention_bias_bound_s(batch, n, bb["num_heads"],
                                                              bb["head_dim"], itemsize)
