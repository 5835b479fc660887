"""Random weights of a ZoeDepth configuration, drawn from a seed on the
device in one large call, as a float32 state dict under the released
``ZoeD_M12_N.pt`` names (``core.core.pretrained.model.*`` for BEiT,
``core.core.pretrained.act_postprocess*`` and ``core.core.scratch.*`` for
the DPT decoder, ``conv2``, ``seed_bin_regressor``, ``seed_projector``,
``projectors``, ``attractors``, ``conditional_log_binomial``).

The names and shapes come from the configuration's widths alone. Both the
program and the reference are handed these tensors (the reference draws
them again from the same seed after the window). Values follow BEiT's and
DPT's init where the magnitude does not hide a fault: normal weights of std
0.02 for the patch embedding, the cls token, the block and readout linears
(every draw cut at two standard deviations), zero linear biases, unit layer
norms, convolutions' biases at their weights' spread. The LayerScale gammas
(``init.layer_scale``) and the relative-position tables (std
``init.rel_pos_table_std``) are drawn at
trained-like magnitudes: at BEiT's init (1e-5, 0.02) every block is nearly
the identity and the bias barely moves the softmax. So are the head's:
convolutions at ``init.conv_gain`` / sqrt(inputs summed into an output),
sorted seed bin biases of std ``init.seed_bin_bias_std``, and the
log-binomial's output convolution at ``init.log_binomial_gain`` times that
with its temperature channels' biases at -/+ ``init.log_binomial_temp_bias``
(at the head's init every depth map is one constant). The configuration's
``assumed`` says why each.
"""

from __future__ import annotations

import math

import torch

SEED_BINS = "seed_bin_regressor._net.2.bias"


def param_specs(cfg: dict) -> list:
    """[(name, shape, std or None, constant)] in a fixed order."""
    bb, dpt, bins = cfg["beit"], cfg["dpt"], cfg["bins"]
    d, ps, heads = bb["embed_dim"], bb["patch_size"], bb["num_heads"]
    hidden = int(d * bb["mlp_ratio"])
    f, chans = dpt["features"], dpt["reassemble_channels"]
    emb = bins["bin_embedding_dim"]
    specs = []

    def w(name, shape, std=0.02):
        specs.append((name, tuple(shape), std, None))

    def c(name, shape, value):
        specs.append((name, tuple(shape), None, value))

    init = cfg["init"]

    def conv(name, cin, cout, k=1, bias=True, transposed=False, gain=1.0, bias_std=None):
        # the inputs summed into one output: cin of a stride-k k x k
        # transposed convolution, cin k^2 of a convolution
        std = init["conv_gain"] / math.sqrt(cin if transposed else cin * k * k)
        w(name + ".weight", (cin, cout, k, k) if transposed else (cout, cin, k, k), gain * std)
        if bias:
            w(name + ".bias", (cout,), std if bias_std is None else bias_std)

    m = "core.core.pretrained.model."
    w(m + "patch_embed.proj.weight", (d, 3, ps, ps))
    c(m + "patch_embed.proj.bias", (d,), 0.0)
    w(m + "cls_token", (1, 1, d))
    n_rel = (2 * bb["pretrain_window"] - 1) ** 2 + 3
    for i in range(bb["depth"]):
        blk = f"{m}blocks.{i}."
        c(blk + "norm1.weight", (d,), 1.0)
        c(blk + "norm1.bias", (d,), 0.0)
        w(blk + "attn.qkv.weight", (3 * d, d))
        c(blk + "attn.q_bias", (d,), 0.0)
        c(blk + "attn.v_bias", (d,), 0.0)
        w(blk + "attn.proj.weight", (d, d))
        c(blk + "attn.proj.bias", (d,), 0.0)
        w(blk + "attn.relative_position_bias_table", (n_rel, heads),
          cfg["init"]["rel_pos_table_std"])
        c(blk + "norm2.weight", (d,), 1.0)
        c(blk + "norm2.bias", (d,), 0.0)
        w(blk + "mlp.fc1.weight", (hidden, d))
        c(blk + "mlp.fc1.bias", (hidden,), 0.0)
        w(blk + "mlp.fc2.weight", (d, hidden))
        c(blk + "mlp.fc2.bias", (d,), 0.0)
        c(blk + "gamma_1", (d,), cfg["init"]["layer_scale"])
        c(blk + "gamma_2", (d,), cfg["init"]["layer_scale"])

    p = "core.core.pretrained."
    for i, ch in enumerate(chans):
        post = f"{p}act_postprocess{i + 1}."
        w(post + "0.project.0.weight", (d, 2 * d))
        c(post + "0.project.0.bias", (d,), 0.0)
        conv(post + "3", d, ch)
        if i in (0, 1):  # the stride-k k x k transposed convolutions
            conv(post + "4", ch, ch, 4 if i == 0 else 2, transposed=True)
        elif i == 3:
            conv(post + "4", ch, ch, 3)
    s = "core.core.scratch."
    for i, ch in enumerate(chans):
        conv(f"{s}layer{i + 1}_rn", ch, f, 3, bias=False)
    for i in range(1, 5):
        for unit in ("resConfUnit1", "resConfUnit2"):
            conv(f"{s}refinenet{i}.{unit}.conv1", f, f, 3)
            conv(f"{s}refinenet{i}.{unit}.conv2", f, f, 3)
        conv(f"{s}refinenet{i}.out_conv", f, f)
    conv(s + "output_conv.0", f, f // 2, 3)
    conv(s + "output_conv.2", f // 2, dpt["n_midas_out"], 3)
    conv(s + "output_conv.4", dpt["n_midas_out"], 1)

    conv("conv2", f, f)
    conv("seed_bin_regressor._net.0", f, bins["seed_mlp_dim"])
    conv("seed_bin_regressor._net.2", bins["seed_mlp_dim"], bins["n_bins"],
         bias_std=init["seed_bin_bias_std"])
    conv("seed_projector._net.0", f, bins["projector_mlp_dim"])
    conv("seed_projector._net.2", bins["projector_mlp_dim"], emb)
    for i in range(len(bins["n_attractors"])):
        conv(f"projectors.{i}._net.0", f, bins["projector_mlp_dim"])
        conv(f"projectors.{i}._net.2", bins["projector_mlp_dim"], emb)
    for i, n in enumerate(bins["n_attractors"]):
        conv(f"attractors.{i}._net.0", emb, bins["attractor_mlp_dim"])
        conv(f"attractors.{i}._net.2", bins["attractor_mlp_dim"], n)
    last = dpt["n_midas_out"] + 1 + emb
    bottleneck = last // bins["log_binomial_bottleneck_factor"]
    conv("conditional_log_binomial.mlp.0", last, bottleneck)
    conv("conditional_log_binomial.mlp.2", bottleneck, 4, bias=False,
         gain=init["log_binomial_gain"])
    tb = init["log_binomial_temp_bias"]
    c("conditional_log_binomial.mlp.2.bias", (4,), [0.0, 0.0, -tb, tb])
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
            out[name] = torch.tensor(const, device=device).expand(shape).clone()
            continue
        out[name] = (flat[off:off + n] * std).reshape(shape)
        off += n
    # the seed bins in the order of k, as a unimodal distribution over k needs
    out[SEED_BINS] = out[SEED_BINS].sort().values
    return out
