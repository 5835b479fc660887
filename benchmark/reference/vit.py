"""Plain PyTorch DINO ViT and DepthG projection head, written from the
published description (DINO's `vision_transformer.py`, STEGO/DepthG's
`DinoFeaturizer`), over a state dict in the Lightning layout.

`dtype` is the backbone's compute type. Layer norms, the softmax and the
position-table resize run in float32; the products run in `dtype` with
float32 accumulation, the attention logits from `dtype` operands in
float32. GELU is exact in float32 and its tanh form in bfloat16 (the
port's stated numerics for a bf16 backbone).

`quantize`, when given, rounds the operands of every product of the
backbone (the linears' weights and inputs, the attention's q, k,
probabilities and v) before the product: the lower-precision control.

Imports nothing but torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ln(x, w, b, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps).to(x.dtype)


def _pos_table(pos: torch.Tensor, n_side: int, grid: int, patch: int, res: int) -> torch.Tensor:
    """DINO's `interpolate_pos_encoding`: a bicubic resize of the patch
    table by the scale factor (res // patch + 0.1) / grid."""
    if n_side == grid:
        return pos
    d = pos.shape[-1]
    table = pos[:, 1:].reshape(1, grid, grid, d).permute(0, 3, 1, 2).float()
    sf = (res // patch + 0.1) / grid
    table = F.interpolate(table, scale_factor=(sf, sf), mode="bicubic", align_corners=False)
    if table.shape[-1] != n_side:
        raise ValueError(f"position table resized to {table.shape[-1]}, expected {n_side}")
    return torch.cat([pos[:, :1], table.permute(0, 2, 3, 1).reshape(1, -1, d)], dim=1)


def vit_features(sd: dict, bb: dict, img: torch.Tensor, dtype=torch.bfloat16,
                 quantize=None) -> torch.Tensor:
    """Patch features of the last block after the final norm, [B, D, h, w]
    float32 (the class token dropped)."""
    q = quantize if quantize is not None else (lambda t: t)
    m = "net.model."
    b, _, hgt, wid = img.shape
    p, d, nh = bb["patch_size"], bb["embed_dim"], bb["num_heads"]
    hd = d // nh
    eps = bb["ln_eps"]

    def lin(x, name):
        return F.linear(q(x), q(sd[name + ".weight"].to(dtype)), sd[name + ".bias"].to(dtype))

    x = F.conv2d(img.to(dtype), sd[m + "patch_embed.proj.weight"].to(dtype),
                 sd[m + "patch_embed.proj.bias"].to(dtype), stride=p)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd[m + "cls_token"].to(dtype).expand(b, 1, d), x], dim=1)
    pos = _pos_table(sd[m + "pos_embed"], hgt // p, bb["pos_embed_grid"], p, wid)
    x = x + pos.to(dtype)
    t = x.shape[1]
    approx = "tanh" if dtype == torch.bfloat16 else "none"
    for i in range(bb["depth"]):
        blk = f"{m}blocks.{i}."
        y = _ln(x, sd[blk + "norm1.weight"], sd[blk + "norm1.bias"], eps)
        qkv = lin(y, blk + "attn.qkv").reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
        qh, kh, vh = q(qkv[0]), q(qkv[1]), q(qkv[2])
        logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * hd ** -0.5
        attn = q(logits.softmax(dim=-1).to(dtype))
        o = torch.matmul(attn, vh).transpose(1, 2).reshape(b, t, d)
        del logits, attn
        x = x + lin(o, blk + "attn.proj")
        y = _ln(x, sd[blk + "norm2.weight"], sd[blk + "norm2.bias"], eps)
        x = x + lin(F.gelu(lin(y, blk + "mlp.fc1"), approximate=approx), blk + "mlp.fc2")
    x = _ln(x, sd[m + "norm.weight"], sd[m + "norm.bias"], eps).float()
    return x[:, 1:].reshape(b, hgt // p, wid // p, d).permute(0, 3, 1, 2)


def conv1x1(sd: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, sd[name + ".weight"], sd[name + ".bias"])


def head_code(sd: dict, f1: torch.Tensor, f2: torch.Tensor | None = None) -> torch.Tensor:
    """cluster1(f1) + cluster2(f2), float32; f1 and f2 are the patch features
    under the head's two dropout masks (both ``f1`` in eval)."""
    f2 = f1 if f2 is None else f2
    return conv1x1(sd, "net.cluster1.0", f1) + conv1x1(
        sd, "net.cluster2.2", F.relu(conv1x1(sd, "net.cluster2.0", f2)))
