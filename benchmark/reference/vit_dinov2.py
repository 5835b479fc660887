"""Plain PyTorch DINOv2 ViT with registers and DepthG's eval around it.

The backbone is written from the published code
(github.com/facebookresearch/dinov2: `dinov2/models/vision_transformer.py`
`DinoVisionTransformer` as `vit_giant2`, `dinov2/layers/swiglu_ffn.py`
`SwiGLUFFNFused`, `dinov2/layers/layer_scale.py`, `dinov2/hub/backbones.py`
`dinov2_vitg14_reg`; arXiv:2304.07193 and arXiv:2309.16588), over a state
dict in the hub's key names under the Lightning prefix `net.model.`:

- tokens: the patch embedding (a p x p conv of stride p), the class token
  before the patches, the position table added to both, then the
  `register_tokens` inserted after the class token;
- the position table: the patch part resized bicubically to the image's
  grid by size with `antialias=True` (`interpolate_offset` 0,
  `interpolate_antialias` True), in float32; not resized for a square
  image at the table's own grid;
- each block: x + ls1 * proj(attn(LN1(x))), then x + ls2 * w3(silu(a) * b)
  with [a, b] = chunk(w12(LN2(x)), 2);
- the final LN; the patch features are the tokens after the class token
  and the registers.

Numerics as `benchmark/reference/vit.py`: `dtype` is the backbone's compute
type; layer norms, the softmax and the table resize run in float32; the
products run in `dtype` with float32 accumulation, the attention logits
from `dtype` operands in float32; the parameters, the position table
among them, are rounded to `dtype` first; the SiLU gate, its product and
the LayerScale product are element-wise in `dtype`, as the published
modules run in it.

Departures from the published code: the eager softmax stands in for
xformers' `MemEffAttention` (the same mathematics); `mask_token` (masked
pretraining only) is not read; the images run in blocks of `BLOCK` so
that the attention maps of a full-width batch fit on one card.

`quantize`, when given, rounds the operands of every product of the
backbone before the product (the lower-precision control). The keyword
faults `registers`, `layer_scale`, `gate` and `antialias` plant a
departure in the backbone (the readings behind the limits of `correct`).

The eval around it is `benchmark/reference/eval.py`'s: the head, the
probes at the label resolution, the frozen CRF copy and the confusion
blocks. Imports nothing but torch and this folder.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import crf as crf_ref
from benchmark.reference import eval as eval_ref
from benchmark.reference.vit import _ln, head_code
from benchmark.scenes import IMAGENET_MEAN, IMAGENET_STD

# images a block of the backbone's forward (the attention maps of 8 images
# at N = 1,029 and 24 heads take 0.8 GB in float32)
BLOCK = 8


def pos_table(pos: torch.Tensor, grid: int, hp: int, wp: int, antialias: bool = True,
              square: bool = True) -> torch.Tensor:
    """DINOv2's `interpolate_pos_encoding` of the [1, 1 + grid^2, D] table
    for an hp x wp patch grid, computed and returned in float32."""
    pos = pos.float()
    if hp * wp == grid * grid and square:
        return pos
    d = pos.shape[-1]
    table = pos[:, 1:].reshape(1, grid, grid, d).permute(0, 3, 1, 2)
    table = F.interpolate(table, size=(hp, wp), mode="bicubic", align_corners=False,
                          antialias=antialias)
    return torch.cat([pos[:, :1], table.permute(0, 2, 3, 1).reshape(1, -1, d)], dim=1)


def _features(sd: dict, bb: dict, img: torch.Tensor, dtype, q, registers: bool,
              layer_scale: bool, gate: str, antialias: bool) -> torch.Tensor:
    m = "net.model."
    b, _, hgt, wid = img.shape
    p, d, nh = bb["patch_size"], bb["embed_dim"], bb["num_heads"]
    hd, eps = bb["head_dim"], bb["ln_eps"]
    hp, wp = hgt // p, wid // p

    def lin(x, name):
        return F.linear(q(x), q(sd[name + ".weight"].to(dtype)), sd[name + ".bias"].to(dtype))

    def scaled(y, name):
        return y * sd[name + ".gamma"].to(dtype) if layer_scale else y

    x = F.conv2d(img.to(dtype), sd[m + "patch_embed.proj.weight"].to(dtype),
                 sd[m + "patch_embed.proj.bias"].to(dtype), stride=p)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd[m + "cls_token"].to(dtype).expand(b, 1, d), x], dim=1)
    x = x + pos_table(sd[m + "pos_embed"].to(dtype), bb["pos_embed_grid"], hp, wp, antialias,
                      square=hgt == wid).to(dtype)
    n_reg = bb["n_registers"] if registers else 0
    if n_reg:
        x = torch.cat([x[:, :1], sd[m + "register_tokens"].to(dtype).expand(b, n_reg, d),
                       x[:, 1:]], dim=1)
    t = x.shape[1]
    for i in range(bb["depth"]):
        blk = f"{m}blocks.{i}."
        y = _ln(x, sd[blk + "norm1.weight"], sd[blk + "norm1.bias"], eps)
        qkv = lin(y, blk + "attn.qkv").reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
        qh, kh, vh = q(qkv[0]), q(qkv[1]), q(qkv[2])
        logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * hd ** -0.5
        attn = q(logits.softmax(dim=-1).to(dtype))
        o = torch.matmul(attn, vh).transpose(1, 2).reshape(b, t, d)
        del logits, attn, qkv
        x = x + scaled(lin(o, blk + "attn.proj"), blk + "ls1")
        y = _ln(x, sd[blk + "norm2.weight"], sd[blk + "norm2.bias"], eps)
        a, g = lin(y, blk + "mlp.w12").chunk(2, dim=-1)
        act = F.silu(a) if gate == "silu" else F.gelu(a)
        x = x + scaled(lin(act * g, blk + "mlp.w3"), blk + "ls2")
    x = _ln(x, sd[m + "norm.weight"], sd[m + "norm.bias"], eps).float()
    return x[:, 1 + n_reg:].reshape(b, hp, wp, d).permute(0, 3, 1, 2)


def vit_features(sd: dict, bb: dict, img: torch.Tensor, dtype=torch.bfloat16, quantize=None,
                 registers: bool = True, layer_scale: bool = True, gate: str = "silu",
                 antialias: bool = True) -> torch.Tensor:
    """Patch features of the last block after the final norm, [B, D, h, w]
    float32 (the class token and the registers dropped), `BLOCK` images at
    a time. The keyword faults: `registers=False` inserts none,
    `layer_scale=False` takes every gamma as 1, `gate="gelu"` gates the
    SwiGLU with exact GELU, `antialias=False` resizes the table without
    antialiasing."""
    q = quantize if quantize is not None else (lambda t: t)
    return torch.cat([_features(sd, bb, img[i:i + BLOCK], dtype, q, registers, layer_scale,
                                gate, antialias) for i in range(0, img.shape[0], BLOCK)])


def tta_code(sd: dict, cfg: dict, img: torch.Tensor, dtype, quantize=None, **fault):
    """((code(img) + flip(code(flip(img)))) / 2 float32, the features of
    `img` and, with flip-TTA, of `flip(img)` after them)."""
    feats = vit_features(sd, cfg["backbone"], img, dtype, quantize, **fault)
    out = head_code(sd, feats)
    if cfg["eval"]["flip_tta"]:
        flipped = vit_features(sd, cfg["backbone"], torch.flip(img, dims=[-1]), dtype,
                               quantize, **fault)
        out = (out + torch.flip(head_code(sd, flipped), dims=[-1])) / 2
        feats = torch.cat([feats, flipped])
    return out, feats


def predict(sd: dict, cfg: dict, img: torch.Tensor, quantize=None, **fault):
    """((linear, cluster) label maps [B, R, R], the features of both
    flip-TTA passes, as `tta_code`'s) of ImageNet-normalized images, as
    `eval.predict` with this backbone."""
    code, feats = tta_code(sd, cfg, img, getattr(torch, cfg["eval"]["backbone_dtype"]),
                           quantize, **fault)
    linear, cluster = eval_ref.probe_logits(sd, cfg, code)
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=img.device)[None, :, None, None]
    guide = (img * std + mean).clamp(0.0, 1.0) * 255.0
    res = cfg["eval"]["res"]
    if guide.shape[-1] != res:
        guide = F.interpolate(guide, size=(res, res), mode="bilinear", align_corners=False)
    linear, cluster = crf_ref.dense_crf(guide, [linear, cluster], cfg["eval"]["crf"])
    return (linear.argmax(1), cluster.argmax(1)), feats


def eval_blocks(sd: dict, cfg: dict, img: torch.Tensor, label: torch.Tensor, quantize=None,
                alter=None, **fault):
    """((linear block, cluster block) of one eval step, the features of
    both flip-TTA passes); `alter` (a fault) changes the label maps before
    they are counted."""
    n, k = cfg["n_classes"], cfg["n_classes"] + cfg["extra_clusters"]
    alter = alter if alter is not None else (lambda p: p)
    (linear, cluster), feats = predict(sd, cfg, img, quantize, **fault)
    return (eval_ref.confusion(alter(linear), label, n, n),
            eval_ref.confusion(alter(cluster), label, n, k)), feats
