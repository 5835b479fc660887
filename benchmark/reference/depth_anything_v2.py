"""Plain PyTorch Depth Anything V2 in float32, written from the published
model (arXiv:2406.09414; github.com/DepthAnything/Depth-Anything-V2:
``depth_anything_v2/dpt.py`` ``DepthAnythingV2`` and ``DPTHead``,
``depth_anything_v2/dinov2.py`` and its ``dinov2_layers``,
``depth_anything_v2/util/blocks.py``). It takes a state dict under the
released names (``pretrained.*``, ``depth_head.*``;
``benchmark.weights_dav2``) and a configuration file's dict.

* The input: [B, 3, H, W] in [0, 1] at the network size (H and W multiples
  of 14), normalized with ImageNet's mean and std (``NormalizeImage``).
* DINOv2: the patch-14 embedding, the class token, the position table
  resized bicubically by the scale factor (grid + 0.1) / 37 without
  antialias (``interpolate_offset`` 0.1, ``interpolate_antialias`` False),
  computed in float32; pre-norm blocks with LayerScale on both branches,
  the qkv bias and exact GELU; ``get_intermediate_layers`` at the hooks
  with the final norm applied and the class token dropped.
* ``DPTHead`` (``use_clstoken`` False): the taps as [B, D, h, w] maps, 1x1
  ``projects``, the ``resize_layers`` (x4 and x2 transposed convolutions,
  identity, the stride-2 3x3 convolution), the 3x3 ``layer{i}_rn``
  convolutions, four fusion blocks of residual conv units with
  ``align_corners=True`` resizes (``refinenet1`` by a scale factor of 2),
  ``output_conv1``, the resize to 14 x the patch grid, ``output_conv2``
  (3x3, ReLU, 1x1, ReLU) and the model's last ReLU: the relative
  disparity.

Float32 throughout with TF32 off (``full_float32``). Options for the
benchmark's control and planted faults: ``quantize`` rounds the operands of
every product before the product (the encoder's linears' weights and
inputs, the attention's q, k, probabilities and v, and every convolution's
of the head); ``norm_taps=False`` hands the head the blocks' raw outputs, as
MiDaS's DPT does; ``hooks`` taps other blocks; ``normalize=False`` skips
the ImageNet normalization; ``layer_scale=False`` leaves the LayerScale
gammas out of every block.

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


def _up(x, size=None, scale=None):
    return F.interpolate(x, size=size, scale_factor=scale, mode="bilinear", align_corners=True)


def pos_embed(pos: torch.Tensor, gh: int, gw: int, offset: float) -> torch.Tensor:
    """DINOv2's ``interpolate_pos_encoding`` for a gh x gw patch grid."""
    n = pos.shape[1] - 1
    if n == gh * gw and gh == gw:
        return pos
    side = math.sqrt(n)
    grid = pos[:, 1:].float().reshape(1, int(side), int(side), -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((gh + offset) / side, (gw + offset) / side),
                         mode="bicubic", antialias=False)
    if tuple(grid.shape[-2:]) != (gh, gw):
        raise ValueError(f"the table resizes to {tuple(grid.shape[-2:])}, not {(gh, gw)}")
    return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)


def encoder_taps(sd: dict, cfg: dict, x: torch.Tensor, quantize=None, norm_taps: bool = True,
                 hooks=None, layer_scale: bool = True) -> list:
    """The patch tokens [B, h w, D] of the hooked blocks' outputs (through
    the final norm unless ``norm_taps`` is False) of the normalized input."""
    q = quantize if quantize is not None else _same
    enc = cfg["encoder"]
    hooks = cfg["dpt"]["hooks"] if hooks is None else hooks
    p = "pretrained."
    d, nh, ps, eps = enc["embed_dim"], enc["num_heads"], enc["patch_size"], enc["ln_eps"]
    b = x.shape[0]
    gh, gw = x.shape[-2] // ps, x.shape[-1] // ps
    tok = F.conv2d(x, sd[p + "patch_embed.proj.weight"], sd[p + "patch_embed.proj.bias"],
                   stride=ps).flatten(2).transpose(1, 2)
    tok = torch.cat([sd[p + "cls_token"].expand(b, 1, d), tok], dim=1)
    tok = tok + pos_embed(sd[p + "pos_embed"], gh, gw, enc["interpolate_offset"])
    n = tok.shape[1]
    scale = (d // nh) ** -0.5

    def lin(t, name):
        return F.linear(q(t), q(sd[name + ".weight"]), sd[name + ".bias"])

    def ls(t, name):
        return sd[name] * t if layer_scale else t

    taps = {}
    for i in range(max(hooks) + 1):
        blk = f"{p}blocks.{i}."
        y = F.layer_norm(tok, (d,), sd[blk + "norm1.weight"], sd[blk + "norm1.bias"], eps)
        qh, kh, vh = lin(y, blk + "attn.qkv").reshape(b, n, 3, nh, -1).permute(2, 0, 3, 1, 4)
        attn = (q(qh * scale) @ q(kh).transpose(-1, -2)).softmax(dim=-1)
        o = (q(attn) @ q(vh)).transpose(1, 2).reshape(b, n, d)
        del attn
        tok = tok + ls(lin(o, blk + "attn.proj"), blk + "ls1.gamma")
        y = F.layer_norm(tok, (d,), sd[blk + "norm2.weight"], sd[blk + "norm2.bias"], eps)
        y = lin(F.gelu(lin(y, blk + "mlp.fc1")), blk + "mlp.fc2")
        tok = tok + ls(y, blk + "ls2.gamma")
        if i in hooks:
            out = F.layer_norm(tok, (d,), sd[p + "norm.weight"], sd[p + "norm.bias"], eps) \
                if norm_taps else tok
            taps[i] = out[:, 1:]
    return [taps[i] for i in hooks]


def _rcu(sd, name, x, q):
    y = _conv(sd, name + ".conv1", F.relu(x), padding=1, q=q)
    return x + _conv(sd, name + ".conv2", F.relu(y), padding=1, q=q)


def _fusion(sd, name, x, skip, size, q):
    if skip is not None:
        x = x + _rcu(sd, name + ".resConfUnit1", skip, q)
    x = _rcu(sd, name + ".resConfUnit2", x, q)
    x = _up(x, scale=2) if size is None else _up(x, size=tuple(size))
    return _conv(sd, name + ".out_conv", x, q=q)


def dpt_head(sd: dict, cfg: dict, taps: list, grid: tuple, quantize=None) -> tuple:
    """(relative disparity [B, H, W], out_conv [B, 32, H, W]) of the taps on
    a gh x gw patch grid."""
    q = quantize if quantize is not None else _same
    gh, gw = grid
    h = "depth_head."
    maps = []
    for i, tok in enumerate(taps):
        x = tok.permute(0, 2, 1).reshape(tok.shape[0], tok.shape[-1], gh, gw)
        x = _conv(sd, f"{h}projects.{i}", x, q=q)
        if i in (0, 1):
            name = f"{h}resize_layers.{i}"
            x = F.conv_transpose2d(q(x), q(sd[name + ".weight"]), sd[name + ".bias"],
                                   stride=4 if i == 0 else 2)
        elif i == 3:
            x = _conv(sd, f"{h}resize_layers.3", x, stride=2, padding=1, q=q)
        maps.append(x)
    s = h + "scratch."
    l1, l2, l3, l4 = (_conv(sd, f"{s}layer{i + 1}_rn", maps[i], padding=1, q=q)
                      for i in range(4))
    p4 = _fusion(sd, s + "refinenet4", l4, None, l3.shape[-2:], q)
    p3 = _fusion(sd, s + "refinenet3", p4, l3, l2.shape[-2:], q)
    p2 = _fusion(sd, s + "refinenet2", p3, l2, l1.shape[-2:], q)
    p1 = _fusion(sd, s + "refinenet1", p2, l1, None, q)
    ps = cfg["encoder"]["patch_size"]
    y = _up(_conv(sd, s + "output_conv1", p1, padding=1, q=q), size=(gh * ps, gw * ps))
    out_conv = F.relu(_conv(sd, s + "output_conv2.0", y, padding=1, q=q))
    disp = F.relu(_conv(sd, s + "output_conv2.2", out_conv, q=q))
    return F.relu(disp)[:, 0], out_conv


def forward(sd: dict, cfg: dict, x: torch.Tensor, quantize=None, norm_taps: bool = True,
            hooks=None, normalize: bool = True, layer_scale: bool = True) -> torch.Tensor:
    """``DepthAnythingV2.forward`` on a [B, 3, H, W] image in [0, 1] at the
    network size: the relative disparity [B, H, W]."""
    if normalize:
        mean = torch.tensor(cfg["input"]["mean"], device=x.device).reshape(1, 3, 1, 1)
        std = torch.tensor(cfg["input"]["std"], device=x.device).reshape(1, 3, 1, 1)
        x = (x - mean) / std
    ps = cfg["encoder"]["patch_size"]
    taps = encoder_taps(sd, cfg, x, quantize, norm_taps, hooks, layer_scale)
    return dpt_head(sd, cfg, taps, (x.shape[-2] // ps, x.shape[-1] // ps), quantize)[0]


def disparity_maps(sd: dict, cfg: dict, x: torch.Tensor, block: int = 4,
                   **opts) -> torch.Tensor:
    """The disparity [B, 1, H, W] of a batch, ``block`` images at a time,
    float32 with TF32 off."""
    with full_float32(), torch.no_grad():
        return torch.cat([forward(sd, cfg, x[i:i + block], **opts)[:, None]
                          for i in range(0, x.shape[0], block)])
