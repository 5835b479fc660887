"""Random weights of a DINOv2 configuration, drawn from a seed on the device
in one large call, as a float32 state dict in the Lightning layout with the
backbone under the DINOv2 hub's key names (`net.model.cls_token`,
`pos_embed`, `register_tokens`, `patch_embed.proj.*`, `blocks.i.{norm1,
attn.qkv, attn.proj, ls1.gamma, norm2, mlp.w12, mlp.w3, ls2.gamma}`,
`norm`; no `mask_token`, which inference never reads), the head and the
probes as `benchmark/weights.py` has them.

The names and shapes come from the configuration's widths alone. Both the
program and the reference are handed these tensors (the reference draws
them again from the same seed after the window). Values follow DINOv2's
init where the magnitude does not hide a fault: normal weights of std 0.02
(cut at two standard deviations) for the patch embedding, the class token
and the position table, of std `init.linear_std` (DINOv2's 0.02 at the
published widths) for the block linears and their biases, unit layer
norms, zero norm biases. The LayerScale gammas (`init.layer_scale`), the
register tokens (std `init.register_std`) and the query and key rows of
each `attn.qkv` (std `init.qk_std`) are drawn at trained-like magnitudes:
at DINOv2's init (1e-5, 1e-6, 0.02) every block is nearly the identity,
the registers are nearly zero and every softmax is nearly uniform, so the
4 registers take 4 / 1,029 of each row and a block or register fault
would not show. The configuration's `assumed` says why.
"""

from __future__ import annotations

import math

import torch

from benchmark.weights import param_specs as dino_specs


def param_specs(cfg: dict) -> list:
    """[(name, shape, std or None, constant)] in a fixed order."""
    bb, init = cfg["backbone"], cfg["init"]
    d, p, hidden = bb["embed_dim"], bb["patch_size"], bb["ffn_hidden"]
    std = init["linear_std"]
    specs = []

    def w(name, shape, std=0.02):
        specs.append((name, tuple(shape), std, None))

    def c(name, shape, value):
        specs.append((name, tuple(shape), None, value))

    m = "net.model."
    w(m + "patch_embed.proj.weight", (d, 3, p, p))
    w(m + "patch_embed.proj.bias", (d,))
    w(m + "cls_token", (1, 1, d))
    w(m + "pos_embed", (1, bb["pos_embed_grid"] ** 2 + 1, d))
    w(m + "register_tokens", (1, bb["n_registers"], d), init["register_std"])
    for i in range(bb["depth"]):
        blk = f"{m}blocks.{i}."
        c(blk + "norm1.weight", (d,), 1.0)
        c(blk + "norm1.bias", (d,), 0.0)
        w(blk + "attn.qkv.weight", (3 * d, d), std)
        w(blk + "attn.qkv.bias", (3 * d,), std)
        w(blk + "attn.proj.weight", (d, d), std)
        w(blk + "attn.proj.bias", (d,), std)
        c(blk + "ls1.gamma", (d,), init["layer_scale"])
        c(blk + "norm2.weight", (d,), 1.0)
        c(blk + "norm2.bias", (d,), 0.0)
        w(blk + "mlp.w12.weight", (2 * hidden, d), std)
        w(blk + "mlp.w12.bias", (2 * hidden,), std)
        w(blk + "mlp.w3.weight", (d, hidden), std)
        w(blk + "mlp.w3.bias", (d,), std)
        c(blk + "ls2.gamma", (d,), init["layer_scale"])
    c(m + "norm.weight", (d,), 1.0)
    c(m + "norm.bias", (d,), 0.0)
    # the head and probes: DINO v1's specs at this width (no block drawn)
    head_cfg = {**cfg, "backbone": {**bb, "depth": 0, "mlp_ratio": 0}}
    specs += [s for s in dino_specs(head_cfg) if not s[0].startswith(m)]
    return specs


def make_state_dict(cfg: dict, seed: int, device) -> dict:
    """Float32 tensors on ``device``: one normal draw for every random
    parameter, cut at two standard deviations, then views per name."""
    specs = param_specs(cfg)
    total = sum(math.prod(s) for _, s, std, _ in specs if std is not None)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, off = {}, 0
    for name, shape, std, const in specs:
        n = math.prod(shape)
        if std is None:
            out[name] = torch.full(shape, const, device=device)
            continue
        out[name] = (flat[off:off + n] * std).reshape(shape)
        off += n
    # the query and key rows of each block's qkv at their own spread
    qk, d = cfg["init"]["qk_std"] / cfg["init"]["linear_std"], cfg["backbone"]["embed_dim"]
    for i in range(cfg["backbone"]["depth"]):
        out[f"net.model.blocks.{i}.attn.qkv.weight"][:2 * d] *= qk
    return out
