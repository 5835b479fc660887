"""Cluster and linear probes (``depthg_tpu/models/probes.py``), eval side.

* ``ClusterLookup``: learned centroids (``cluster_probe.clusters``), cosine
  inner products, log-softmax of ``ip * alpha`` for the CRF eval path;
* the linear probe is a 1x1 ``nn.Conv2d`` (``linear_probe.weight``).

The cluster loss and the reconstruction decoders belong to training.
"""

from __future__ import annotations

import torch
from torch import nn

from depthg_tpu_torch.ops.correlation import norm
from depthg_tpu_torch.ops.resize import resize_bilinear, resized_sq_norm


class ClusterLookup(nn.Module):
    def __init__(self, dim: int, n_classes: int):
        super().__init__()
        self.clusters = nn.Parameter(torch.zeros(n_classes, dim))


def cluster_lookup_apply(clusters: torch.Tensor, x: torch.Tensor, alpha: float,
                         normalized: bool = True) -> torch.Tensor:
    """Cluster log-probs of x [B, dim, H, W] (the JAX ``log_probs=True`` mode).

    ``normalized=False`` returns the raw ``ip * alpha`` logits, which are
    shift-equivalent for softmax/argmax consumers."""
    ip = torch.einsum("bchw,nc->bnhw", norm(x.float(), dim=1),
                      norm(clusters.float(), dim=1))
    return ip * alpha if not normalized else torch.log_softmax(ip * alpha, dim=1)


def cluster_lookup_resized(clusters: torch.Tensor, x: torch.Tensor, size,
                           alpha: float, normalized: bool = True) -> torch.Tensor:
    """``cluster_lookup_apply(clusters, resize_bilinear(x, size), alpha)``
    computed from the low-resolution code, without the resized
    [B, dim, R, R] tensor: the channel dots commute with the resize, and the
    per-pixel norm |resize(x)| expands exactly through the 2-tap bilinear
    rows (``resized_sq_norm``)."""
    x = x.float()
    dots = torch.einsum("bchw,nc->bnhw", x, norm(clusters.float(), dim=1))
    code_norm = resized_sq_norm(x, size).sqrt()  # [B, R, R]
    ip = resize_bilinear(dots, size) / code_norm[:, None].clamp_min(1e-10)
    return ip * alpha if not normalized else torch.log_softmax(ip * alpha, dim=1)
