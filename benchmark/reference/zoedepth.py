"""Plain PyTorch ZoeDepth ZoeD_M12_N in float32, written from the published
model: ZoeDepth's ``zoedepth_v1.py``, ``layers/attractor.py``,
``layers/dist_layers.py``, ``layers/localbins_layers.py``,
``base_models/midas.py`` and ``depth_model.py`` (arXiv:2302.12288), over
MiDaS v3.1's ``DPT_BEiT_L_384`` (``backbones/beit.py``, ``blocks.py``,
``dpt_depth.py``; arXiv:2307.14460) and timm's ``beit_large_patch16_384``
(arXiv:2106.08254). It takes a state dict under the released names
(``benchmark.weights_zoedepth``) and a configuration file's dict.

* BEiT: patch-16 embedding, cls token, no absolute position embedding;
  pre-norm blocks with LayerScale, the qkv bias ``cat(q_bias, 0, v_bias)``,
  exact GELU, and per block a relative-position bias whose 2-D table is
  resized bilinearly (``align_corners=False``) from the pretraining window
  to the input's patch grid (MiDaS's ``_get_rel_pos_bias``), the three cls
  entries kept, then gathered by the (h w + 1)^2 relative index.
* DPT: the blocks' outputs at the hooks, the project readout (exact GELU),
  1x1 projections, the x4 and x2 transposed convolutions and the stride-2
  3x3 convolution, the 3x3 ``layer{i}_rn`` convolutions, four fusion
  blocks of residual conv units with ``align_corners=True`` resizes, and
  the head up to its ``out_conv`` activation (the ReLU after its second
  convolution) and the relative depth.
* The metric-bins head: ``conv2`` on ``l4_rn``, the softplus seed bins,
  the seed projector, the attractor stages on r4, r3, r2, r1, the
  conditional log-binomial over ``n_bins`` on [out_conv, relative depth]
  and the bin embedding, and depth = sum p c.
* Inference: reflect pad by int(sqrt(side / 2) x 3), MiDaS's prep resize
  (aspect kept, multiples of 32, "minimal", bilinear ``align_corners=True``,
  0.5 / 0.5 normalization), bicubic back to the padded size, the crop, and
  the horizontal flip averaged.

Departures from the published model, each noted: (1) the attractors run
with ``inv_attractor``'s default alpha 300 and gamma 2, as the published
layer calls it, whatever the configuration's ``attractor_alpha`` (1000)
says; the configuration's value is not used. (2) Only the softplus bin
centers of ZoeD_M12_N are written (``bin_centers_type: softplus``;
``normed`` raises). (3) ``inverse_midas`` is off in ZoeD_M12_N and raises
here. (4) The ``feats`` returned are the last bin embedding resized to the
output, which DepthG's depth generation keeps beside the depth (the
published forward does not return it).

Float32 throughout with TF32 off (``full_float32``). Options for the
benchmark's control and planted faults: ``quantize`` rounds the operands of
every product before the product: BEiT's (the linears' weights and inputs,
the attention's q, k, probabilities and v), and every convolution's and
readout linear's of the decoder and the head; ``rel_bias=False`` leaves the
relative-position bias out of every block; ``attractors`` runs only the
first that many attractor stages; ``flip=False`` leaves the flip pass out.

Imports nothing but torch.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_float32():
    """Float32 products without TF32 inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _same(t):
    return t


def _conv(sd, name, x, stride=1, padding=0, q=_same):
    return F.conv2d(q(x), q(sd[name + ".weight"]), sd.get(name + ".bias"), stride=stride,
                    padding=padding)


def _up(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


def rel_position_index(h: int, w: int, device) -> torch.Tensor:
    """timm / MiDaS ``gen_relative_position_index`` of an h x w window:
    [h w + 1, h w + 1] indices into the (2h-1)(2w-1) + 3 entry table."""
    n_rel = (2 * h - 1) * (2 * w - 1)
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    coords = torch.stack([ys.flatten(), xs.flatten()])  # [2, h w]
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    idx = torch.zeros(h * w + 1, h * w + 1, dtype=torch.long)
    idx[1:, 1:] = (rel[..., 0] + h - 1) * (2 * w - 1) + rel[..., 1] + w - 1
    idx[0, 0:] = n_rel
    idx[0:, 0] = n_rel + 1
    idx[0, 0] = n_rel + 2
    return idx.to(device)


def rel_position_bias(table: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """[heads, N, N] bias of an h x w patch grid from a table built for a
    window x window one: its 2-D part resized bilinearly."""
    old = 2 * window - 1
    sub = table[:old * old].reshape(1, old, old, -1).permute(0, 3, 1, 2)
    sub = F.interpolate(sub, size=(2 * h - 1, 2 * w - 1), mode="bilinear")
    sub = sub.permute(0, 2, 3, 1).reshape((2 * h - 1) * (2 * w - 1), -1)
    full = torch.cat([sub, table[old * old:]])
    idx = rel_position_index(h, w, table.device)
    return full[idx.reshape(-1)].reshape(idx.shape[0], idx.shape[1], -1).permute(2, 0, 1)


def beit_taps(sd: dict, cfg: dict, x: torch.Tensor, quantize=None, rel_bias: bool = True):
    """The blocks' outputs at the hooks ([B, 1 + h w, D] each) of the
    prep-normalized [B, 3, H, W] input, and its (h, w) patch grid."""
    q = quantize if quantize is not None else _same
    bb = cfg["beit"]
    m = "core.core.pretrained.model."
    d, nh, ps, eps = bb["embed_dim"], bb["num_heads"], bb["patch_size"], bb["ln_eps"]
    b = x.shape[0]
    h, w = x.shape[-2] // ps, x.shape[-1] // ps
    tok = F.conv2d(x, sd[m + "patch_embed.proj.weight"], sd[m + "patch_embed.proj.bias"],
                   stride=ps).flatten(2).transpose(1, 2)
    tok = torch.cat([sd[m + "cls_token"].expand(b, 1, d), tok], dim=1)
    n = tok.shape[1]
    scale = (d // nh) ** -0.5

    def lin(t, weight, bias):
        return F.linear(q(t), q(weight), bias)

    taps = []
    for i in range(bb["depth"]):
        blk = f"{m}blocks.{i}."
        y = F.layer_norm(tok, (d,), sd[blk + "norm1.weight"], sd[blk + "norm1.bias"], eps)
        qkv_bias = torch.cat([sd[blk + "attn.q_bias"], torch.zeros_like(sd[blk + "attn.q_bias"]),
                              sd[blk + "attn.v_bias"]])
        qkv = lin(y, sd[blk + "attn.qkv.weight"], qkv_bias)
        qh, kh, vh = qkv.reshape(b, n, 3, nh, -1).permute(2, 0, 3, 1, 4)
        logits = q(qh * scale) @ q(kh).transpose(-1, -2)
        if rel_bias:
            logits = logits + rel_position_bias(sd[blk + "attn.relative_position_bias_table"],
                                                bb["pretrain_window"], h, w)
        o = (q(logits.softmax(dim=-1)) @ q(vh)).transpose(1, 2).reshape(b, n, d)
        del logits
        tok = tok + sd[blk + "gamma_1"] * lin(o, sd[blk + "attn.proj.weight"],
                                              sd[blk + "attn.proj.bias"])
        y = F.layer_norm(tok, (d,), sd[blk + "norm2.weight"], sd[blk + "norm2.bias"], eps)
        y = lin(F.gelu(lin(y, sd[blk + "mlp.fc1.weight"], sd[blk + "mlp.fc1.bias"])),
                sd[blk + "mlp.fc2.weight"], sd[blk + "mlp.fc2.bias"])
        tok = tok + sd[blk + "gamma_2"] * y
        if i in bb["hooks"]:
            taps.append(tok)
    return taps, (h, w)


def _rcu(sd, name, x, q):
    y = _conv(sd, name + ".conv1", F.relu(x), padding=1, q=q)
    return x + _conv(sd, name + ".conv2", F.relu(y), padding=1, q=q)


def _fusion(sd, name, x, skip, size, q):
    if skip is not None:
        x = x + _rcu(sd, name + ".resConfUnit1", skip, q)
    x = _rcu(sd, name + ".resConfUnit2", x, q)
    return _conv(sd, name + ".out_conv", _up(x, size), q=q)


def dpt_decode(sd: dict, cfg: dict, taps: list, hw: tuple, quantize=None):
    """(relative depth [B, H, W], {out_conv, l4_rn, r4, r3, r2, r1})."""
    q = quantize if quantize is not None else _same
    h, w = hw
    p = "core.core.pretrained."
    maps = []
    for i, tok in enumerate(taps):
        post = f"{p}act_postprocess{i + 1}."
        patches = tok[:, 1:]
        read = F.gelu(F.linear(q(torch.cat([patches, tok[:, :1].expand_as(patches)], dim=-1)),
                               q(sd[post + "0.project.0.weight"]), sd[post + "0.project.0.bias"]))
        fmap = _conv(sd, post + "3", read.transpose(1, 2).reshape(tok.shape[0], -1, h, w), q=q)
        if i in (0, 1):
            k = 4 if i == 0 else 2
            fmap = F.conv_transpose2d(q(fmap), q(sd[post + "4.weight"]), sd[post + "4.bias"],
                                      stride=k)
        elif i == 3:
            fmap = _conv(sd, post + "4", fmap, stride=2, padding=1, q=q)
        maps.append(fmap)
    s = "core.core.scratch."
    l1, l2, l3, l4 = (_conv(sd, f"{s}layer{i + 1}_rn", maps[i], padding=1, q=q)
                      for i in range(4))
    r4 = _fusion(sd, s + "refinenet4", l4, None, l3.shape[-2:], q)
    r3 = _fusion(sd, s + "refinenet3", r4, l3, l2.shape[-2:], q)
    r2 = _fusion(sd, s + "refinenet2", r3, l2, l1.shape[-2:], q)
    r1 = _fusion(sd, s + "refinenet1", r2, l1, (2 * l1.shape[-2], 2 * l1.shape[-1]), q)
    y = _conv(sd, s + "output_conv.0", r1, padding=1, q=q)
    y = _up(y, (2 * y.shape[-2], 2 * y.shape[-1]))
    out_conv = F.relu(_conv(sd, s + "output_conv.2", y, padding=1, q=q))
    rel = F.relu(_conv(sd, s + "output_conv.4", out_conv, q=q))[:, 0]
    return rel, {"out_conv": out_conv, "l4_rn": l4, "r4": r4, "r3": r3, "r2": r2, "r1": r1}


def _mlp(sd, name, x, q, act=F.relu):
    return _conv(sd, name + ".2", act(_conv(sd, name + ".0", x, q=q)), q=q)


def _inv_attractor(dx, alpha=300.0, gamma=2):
    return dx / (1 + alpha * dx.pow(gamma))


def metric_bins(sd: dict, cfg: dict, rel: torch.Tensor, hooks: dict, attractors=None,
                quantize=None):
    """(metric depth [B, 1, H, W], feats [B, emb, H, W]) of the decoder's
    outputs, with the first ``attractors`` stages (all when None)."""
    q = quantize if quantize is not None else _same
    bins = cfg["bins"]
    if bins["bin_centers_type"] != "softplus" or bins["inverse_midas"]:
        raise ValueError("the reference writes ZoeD_M12_N's softplus bins without inverse_midas")
    x = _conv(sd, "conv2", hooks["l4_rn"], q=q)
    b_prev = F.softplus(_mlp(sd, "seed_bin_regressor._net", x, q))
    prev_emb = _mlp(sd, "seed_projector._net", x, q)
    stages = len(bins["n_attractors"]) if attractors is None else attractors
    for i, blk in enumerate((hooks["r4"], hooks["r3"], hooks["r2"], hooks["r1"])[:stages]):
        emb = _mlp(sd, f"projectors.{i}._net", blk, q)
        a = F.softplus(_mlp(sd, f"attractors.{i}._net", emb + _up(prev_emb, emb.shape[-2:]), q))
        centers = _up(b_prev, a.shape[-2:])
        delta = _inv_attractor(a.unsqueeze(2) - centers.unsqueeze(1))
        delta = delta.mean(dim=1) if bins["attractor_kind"] == "mean" else delta.sum(dim=1)
        b_prev, prev_emb = centers + delta, emb
    last = hooks["out_conv"]
    last = torch.cat([last, _up(rel[:, None], last.shape[-2:])], dim=1)
    emb_up = _up(prev_emb, last.shape[-2:])
    pt = _mlp(sd, "conditional_log_binomial.mlp", torch.cat([last, emb_up], dim=1), q, F.gelu)
    pt = F.softplus(pt) + 1e-4
    p = (pt[:, 0] / (pt[:, 0] + pt[:, 1]))[:, None]
    t = (pt[:, 2] / (pt[:, 2] + pt[:, 3]))[:, None]
    t = (bins["max_temp"] - bins["min_temp"]) * t + bins["min_temp"]
    big_k = float(bins["n_bins"] - 1)
    k = torch.arange(bins["n_bins"], device=rel.device).reshape(1, -1, 1, 1)

    def log_binom(n, r, eps=1e-7):
        n, r = n + eps, r + eps
        return n * torch.log(n) - r * torch.log(r) - (n - r) * torch.log(n - r + eps)

    y = log_binom(torch.full_like(k, big_k, dtype=torch.float32), k) \
        + k * torch.log(p.clamp(1e-4, 1)) + (big_k - k) * torch.log((1 - p).clamp(1e-4, 1))
    probs = torch.softmax(y / t, dim=1)
    centers = _up(b_prev, probs.shape[-2:])
    return (probs * centers).sum(dim=1, keepdim=True), emb_up


def forward(sd: dict, cfg: dict, x: torch.Tensor, quantize=None, rel_bias: bool = True,
            attractors=None) -> dict:
    """ZoeDepth's forward on a prep-normalized [B, 3, H, W] input."""
    taps, hw = beit_taps(sd, cfg, x, quantize, rel_bias)
    rel, hooks = dpt_decode(sd, cfg, taps, hw, quantize)
    depth, feats = metric_bins(sd, cfg, rel, hooks, attractors, quantize)
    return {"rel_depth": rel, "metric_depth": depth, "feats": feats}


def prep_size(h: int, w: int, cfg: dict) -> tuple:
    """MiDaS ``Resize.get_size``: aspect kept, the "minimal" scale, each
    side rounded to a multiple of 32."""
    net_h, net_w = cfg["img_size"]
    scale_h, scale_w = net_h / h, net_w / w
    scale = scale_w if abs(1 - scale_w) < abs(1 - scale_h) else scale_h
    return int(round(scale * h / 32) * 32), int(round(scale * w / 32) * 32)


def _infer_with_pad(sd, cfg, x, **opts):
    h, w = x.shape[-2:]
    pad_h, pad_w = int(math.sqrt(h / 2) * 3), int(math.sqrt(w / 2) * 3)
    x = F.pad(x, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    xp = F.interpolate(x, size=prep_size(*x.shape[-2:], cfg), mode="bilinear",
                       align_corners=True)
    out = forward(sd, cfg, (xp - 0.5) / 0.5, **opts)
    depth = F.interpolate(out["metric_depth"], size=x.shape[-2:], mode="bicubic",
                          align_corners=False)
    return depth[:, :, pad_h:-pad_h, pad_w:-pad_w], out["feats"]


def infer(sd: dict, cfg: dict, x: torch.Tensor, flip: bool = True, **opts):
    """``DepthModel.infer`` with the pad and the flip: (metric depth
    [B, 1, H, W], feats) of raw [B, 3, H, W] images in [0, 1]."""
    depth, feats = _infer_with_pad(sd, cfg, x, **opts)
    if flip:
        depth_f, feats_f = _infer_with_pad(sd, cfg, x.flip(-1), **opts)
        depth = (depth + depth_f.flip(-1)) / 2
        feats = (feats + feats_f.flip(-1)) / 2
    return depth, feats


def depth_maps(sd: dict, cfg: dict, x: torch.Tensor, block: int = 4, **opts) -> torch.Tensor:
    """The metric depth of a batch, ``block`` images at a time, float32
    with TF32 off."""
    with full_float32(), torch.no_grad():
        return torch.cat([infer(sd, cfg, x[i:i + block], **opts)[0]
                          for i in range(0, x.shape[0], block)])
