"""Plain PyTorch eval step of DepthG (the reference `eval_segmentation.py`
inner loop): flip-TTA code, the linear and cluster probes at the label
resolution, the dense CRF on both, the argmax and the [K, C] confusion
blocks stats[pred, actual]. Imports nothing but torch and this folder.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import crf as crf_ref
from benchmark.reference.vit import head_code, vit_features
from benchmark.scenes import IMAGENET_MEAN, IMAGENET_STD


def tta_code(sd: dict, cfg: dict, img: torch.Tensor, dtype, quantize=None) -> torch.Tensor:
    """(code(img) + flip(code(flip(img)))) / 2, float32."""
    bb = cfg["backbone"]

    def code(x):
        return head_code(sd, vit_features(sd, bb, x, dtype, quantize))

    out = code(img)
    if cfg["eval"]["flip_tta"]:
        out = (out + torch.flip(code(torch.flip(img, dims=[-1])), dims=[-1])) / 2
    return out


def probe_logits(sd: dict, cfg: dict, code: torch.Tensor):
    """(linear logits, cluster logits alpha * cos) at the label resolution:
    the code is upsampled first, then classified."""
    res = cfg["eval"]["res"]
    up = F.interpolate(code, size=(res, res), mode="bilinear", align_corners=False)
    linear = F.conv2d(up, sd["linear_probe.weight"], sd["linear_probe.bias"])
    cos = torch.einsum("bchw,nc->bnhw", F.normalize(up, dim=1, eps=1e-10),
                       F.normalize(sd["cluster_probe.clusters"], dim=1, eps=1e-10))
    return linear, cos * cfg["eval"]["cluster_alpha"]


def confusion(preds: torch.Tensor, label: torch.Tensor, n_classes: int, k: int) -> torch.Tensor:
    """[k, n_classes] int64 counts of (pred, actual) over pixels whose label
    lies in [0, n_classes)."""
    keep = (label >= 0) & (label < n_classes) & (preds >= 0) & (preds < n_classes)
    idx = preds[keep].long() * n_classes + label[keep].long()
    return torch.bincount(idx, minlength=k * n_classes).reshape(k, n_classes)


def predict(sd: dict, cfg: dict, img: torch.Tensor, quantize=None):
    """(linear, cluster) label maps [B, R, R] of ImageNet-normalized images,
    the backbone in the configuration's dtype."""
    code = tta_code(sd, cfg, img, getattr(torch, cfg["eval"]["backbone_dtype"]), quantize)
    linear, cluster = probe_logits(sd, cfg, code)
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=img.device)[None, :, None, None]
    guide = (img * std + mean).clamp(0.0, 1.0) * 255.0
    res = cfg["eval"]["res"]
    if guide.shape[-1] != res:
        guide = F.interpolate(guide, size=(res, res), mode="bilinear", align_corners=False)
    linear, cluster = crf_ref.dense_crf(guide, [linear, cluster], cfg["eval"]["crf"])
    return linear.argmax(1), cluster.argmax(1)


def eval_blocks(sd: dict, cfg: dict, img: torch.Tensor, label: torch.Tensor,
                quantize=None, alter=None):
    """(linear block, cluster block) of one eval step; ``alter`` (a fault)
    changes the label maps before they are counted."""
    n, k = cfg["n_classes"], cfg["n_classes"] + cfg["extra_clusters"]
    alter = alter if alter is not None else (lambda p: p)
    linear, cluster = predict(sd, cfg, img, quantize)
    return (confusion(alter(linear), label, n, n), confusion(alter(cluster), label, n, k))
