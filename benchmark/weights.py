"""Random weights of a configuration, drawn from a seed on the device in one
large call, as a state dict in the reference Lightning layout
(`net.model.*` for the ViT, `net.cluster1/2.*` for the head,
`linear_probe.*`, `cluster_probe.clusters`, `decoder.*`).

The names and shapes come from the configuration's widths alone. Both the
program and the reference are handed these tensors (the reference draws
them again from the same seed after the window). Initial values follow
DINO's init where it has one: normal weights of std 0.02 (cut at two
standard deviations), unit layer norms, zero norm biases; 1x1 convs with
torch's default spread (std = 1 / sqrt(3 fan_in)); standard normal
centroids.
"""

from __future__ import annotations

import math

import torch


def param_specs(cfg: dict, decoder: bool = False) -> list:
    """[(name, shape, std or None, constant)] in a fixed order."""
    bb, head = cfg["backbone"], cfg["head"]
    d, p, dim = bb["embed_dim"], bb["patch_size"], head["dim"]
    hidden = int(d * bb["mlp_ratio"])
    k = cfg["n_classes"] + cfg["extra_clusters"]
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
    for i in range(bb["depth"]):
        blk = f"{m}blocks.{i}."
        c(blk + "norm1.weight", (d,), 1.0)
        c(blk + "norm1.bias", (d,), 0.0)
        w(blk + "attn.qkv.weight", (3 * d, d))
        w(blk + "attn.qkv.bias", (3 * d,))
        w(blk + "attn.proj.weight", (d, d))
        w(blk + "attn.proj.bias", (d,))
        c(blk + "norm2.weight", (d,), 1.0)
        c(blk + "norm2.bias", (d,), 0.0)
        w(blk + "mlp.fc1.weight", (hidden, d))
        w(blk + "mlp.fc1.bias", (hidden,))
        w(blk + "mlp.fc2.weight", (d, hidden))
        w(blk + "mlp.fc2.bias", (d,))
    c(m + "norm.weight", (d,), 1.0)
    c(m + "norm.bias", (d,), 0.0)

    def conv(name, cin, cout):
        std = 1.0 / math.sqrt(3.0 * cin)
        w(name + ".weight", (cout, cin, 1, 1), std)
        w(name + ".bias", (cout,), std)

    conv("net.cluster1.0", d, dim)
    conv("net.cluster2.0", d, d)
    conv("net.cluster2.2", d, dim)
    conv("linear_probe", dim, cfg["n_classes"])
    w("cluster_probe.clusters", (k, dim), 1.0)
    if decoder:
        conv("decoder", dim, d)
    return specs


def make_state_dict(cfg: dict, seed: int, device, decoder: bool = False) -> dict:
    """Float32 tensors on ``device``: one normal draw for every random
    parameter, cut at two standard deviations, then views per name."""
    specs = param_specs(cfg, decoder)
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
    return out
