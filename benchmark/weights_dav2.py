"""Random weights of a Depth Anything V2 configuration, drawn from a seed on
the device in one large call, as a float32 state dict under the released
``depth_anything_v2_vitl.pth`` names: ``pretrained.*`` for the DINOv2
encoder (``cls_token``, ``pos_embed``, ``mask_token``, ``patch_embed.proj``,
``blocks.i.{norm1, attn.qkv, attn.proj, ls1.gamma, norm2, mlp.fc1, mlp.fc2,
ls2.gamma}``, ``norm``) and ``depth_head.*`` for the DPT head
(``projects``, ``resize_layers``, ``scratch.layer{i}_rn``,
``scratch.refinenet{i}``, ``scratch.output_conv1``, ``scratch.output_conv2``).

The names and shapes come from the configuration's widths alone. Both the
program (through the port's loader of these names) and the reference are
handed these tensors (the reference draws them again from the same seed
after the window). Values follow DINOv2's and DPT's init where the
magnitude does not hide a fault: normal weights of std 0.02 for the patch
embedding, the class token, the position table and the block linears and
their biases (every draw cut at two standard deviations), unit layer norms
with zero biases, a zero ``mask_token`` (never read). The LayerScale gammas
are at ``init.layer_scale``; the head's convolutions at ``init.conv_gain`` /
sqrt(inputs summed into an output), their biases at that spread; the last
convolution's bias at ``init.out_bias``. The configuration's ``assumed``
says why each.
"""

from __future__ import annotations

import math

import torch


def param_specs(cfg: dict) -> list:
    """[(name, shape, std or None, constant)] in a fixed order."""
    enc, dpt, init = cfg["encoder"], cfg["dpt"], cfg["init"]
    d, ps = enc["embed_dim"], enc["patch_size"]
    hidden = int(d * enc["mlp_ratio"])
    f, chans = dpt["features"], dpt["out_channels"]
    specs = []

    def w(name, shape, std=0.02):
        specs.append((name, tuple(shape), std, None))

    def c(name, shape, value):
        specs.append((name, tuple(shape), None, value))

    def conv(name, cin, cout, k=1, bias=True, transposed=False):
        # the inputs summed into one output: cin of a stride-k k x k
        # transposed convolution, cin k^2 of a convolution
        std = init["conv_gain"] / math.sqrt(cin if transposed else cin * k * k)
        w(name + ".weight", (cin, cout, k, k) if transposed else (cout, cin, k, k), std)
        if bias:
            w(name + ".bias", (cout,), std)

    p = "pretrained."
    w(p + "cls_token", (1, 1, d))
    w(p + "pos_embed", (1, enc["pos_embed_grid"] ** 2 + 1, d))
    c(p + "mask_token", (1, d), 0.0)
    w(p + "patch_embed.proj.weight", (d, 3, ps, ps))
    w(p + "patch_embed.proj.bias", (d,))
    for i in range(enc["depth"]):
        blk = f"{p}blocks.{i}."
        c(blk + "norm1.weight", (d,), 1.0)
        c(blk + "norm1.bias", (d,), 0.0)
        w(blk + "attn.qkv.weight", (3 * d, d))
        w(blk + "attn.qkv.bias", (3 * d,))
        w(blk + "attn.proj.weight", (d, d))
        w(blk + "attn.proj.bias", (d,))
        c(blk + "ls1.gamma", (d,), init["layer_scale"])
        c(blk + "norm2.weight", (d,), 1.0)
        c(blk + "norm2.bias", (d,), 0.0)
        w(blk + "mlp.fc1.weight", (hidden, d))
        w(blk + "mlp.fc1.bias", (hidden,))
        w(blk + "mlp.fc2.weight", (d, hidden))
        w(blk + "mlp.fc2.bias", (d,))
        c(blk + "ls2.gamma", (d,), init["layer_scale"])
    c(p + "norm.weight", (d,), 1.0)
    c(p + "norm.bias", (d,), 0.0)

    h = "depth_head."
    for i, ch in enumerate(chans):
        conv(f"{h}projects.{i}", d, ch)
    conv(h + "resize_layers.0", chans[0], chans[0], 4, transposed=True)
    conv(h + "resize_layers.1", chans[1], chans[1], 2, transposed=True)
    conv(h + "resize_layers.3", chans[3], chans[3], 3)
    s = h + "scratch."
    for i, ch in enumerate(chans):
        conv(f"{s}layer{i + 1}_rn", ch, f, 3, bias=False)
    for i in range(1, 5):
        conv(f"{s}refinenet{i}.out_conv", f, f)
        for unit in ("resConfUnit1", "resConfUnit2"):
            conv(f"{s}refinenet{i}.{unit}.conv1", f, f, 3)
            conv(f"{s}refinenet{i}.{unit}.conv2", f, f, 3)
    conv(s + "output_conv1", f, f // 2, 3)
    conv(s + "output_conv2.0", f // 2, dpt["head_features_2"], 3)
    conv(s + "output_conv2.2", dpt["head_features_2"], 1, bias=False)
    c(s + "output_conv2.2.bias", (1,), init["out_bias"])
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
    return out
