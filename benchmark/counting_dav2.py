"""Operations and the attention bound of Depth Anything V2's depth step, the
yardstick of `mfu.depth` and `k1_roofline_pct.eval` in its cell.
Counted from a configuration's published widths and the traffic's image
size, never from the code that runs: the encoder's patch embedding, its
four linears a block over every token and its attention over every token
(`benchmark.counting`'s formulas), and every convolution of the DPT head:
the projections, the resize layers, the `rn` convolutions, the residual
units and 1x1 outputs of the four fusion blocks, `output_conv1` and
`output_conv2`. The layer norms, GELU, LayerScale products, softmax,
resizes and ReLUs are element-wise and not counted. One pass a step (no
flip).
"""

from __future__ import annotations

from benchmark.counting import attention_bound_s, attention_flops


def conv_flops(area: int, cin: int, cout: int, k: int = 1) -> float:
    """A k x k convolution over ``area`` output positions (a stride-k k x k
    transposed one: over its input positions)."""
    return 2.0 * area * cin * cout * k * k


def grid(cfg: dict, height: int, width: int) -> tuple:
    """The patch grid of a network input (a multiple of the patch size)."""
    ps = cfg["encoder"]["patch_size"]
    return height // ps, width // ps


def scales(gh: int, gw: int) -> list:
    """(rows, cols) of the four reassembled maps: 4x, 2x, 1x and 1/2 the
    patch grid (the stride-2 3x3 convolution rounds up)."""
    return [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), ((gh + 1) // 2, (gw + 1) // 2)]


def encoder_flops(cfg: dict, gh: int, gw: int) -> float:
    """One image through the encoder on a gh x gw grid: the patch embedding,
    and per block qkv, proj, fc1, fc2 and the attention over every token."""
    enc = cfg["encoder"]
    d, ps = enc["embed_dim"], enc["patch_size"]
    n = gh * gw + 1
    hidden = int(d * enc["mlp_ratio"])
    linears = 2.0 * n * d * (3 * d + d + 2 * hidden)
    attn = attention_flops(1, enc["num_heads"], n, n, enc["head_dim"])
    return conv_flops(gh * gw, 3, d, ps) + enc["depth"] * (linears + attn)


def head_flops(cfg: dict, gh: int, gw: int) -> float:
    """One image through the DPT head, ``output_conv2`` included."""
    d, dpt = cfg["encoder"]["embed_dim"], cfg["dpt"]
    f, chans = dpt["features"], dpt["out_channels"]
    s = [a * b for a, b in scales(gh, gw)]
    hw = gh * gw
    total = sum(conv_flops(hw, d, ch) for ch in chans)
    total += conv_flops(hw, chans[0], chans[0], 4) + conv_flops(hw, chans[1], chans[1], 2)
    total += conv_flops(s[3], chans[3], chans[3], 3)
    total += sum(conv_flops(s[i], ch, f, 3) for i, ch in enumerate(chans))
    rcu = 2 * conv_flops(1, f, f, 3)  # per position
    total += 1 * rcu * s[3] + conv_flops(s[2], f, f)  # refinenet4: one unit (no skip)
    total += 2 * rcu * s[2] + conv_flops(s[1], f, f)
    total += 2 * rcu * s[1] + conv_flops(s[0], f, f)
    total += 2 * rcu * s[0] + conv_flops(4 * s[0], f, f)
    out = hw * cfg["encoder"]["patch_size"] ** 2  # the input's pixels
    total += conv_flops(4 * s[0], f, f // 2, 3)
    total += conv_flops(out, f // 2, dpt["head_features_2"], 3)
    return total + conv_flops(out, dpt["head_features_2"], 1)


def forward_flops(cfg: dict, height: int, width: int) -> float:
    """One image's forward at a height x width network input."""
    gh, gw = grid(cfg, height, width)
    return encoder_flops(cfg, gh, gw) + head_flops(cfg, gh, gw)


def step_flops(cfg: dict, batch: int, height: int, width: int) -> float:
    """Model work of one depth step on ``batch`` images of height x width."""
    return batch * forward_flops(cfg, height, width)


def step_attention_bound_s(cfg: dict, batch: int, height: int, width: int) -> float:
    """Least seconds of one depth step's attention: one call a block over
    the batch (bf16: q, k, v read and o written, or the operations at the
    peak, whichever is larger)."""
    enc = cfg["encoder"]
    gh, gw = grid(cfg, height, width)
    return enc["depth"] * attention_bound_s(batch, gh * gw + 1, enc["num_heads"],
                                            enc["head_dim"])
