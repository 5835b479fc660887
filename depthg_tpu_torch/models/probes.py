"""Cluster and linear probes and the reconstruction decoders
(``depthg_tpu/models/probes.py``).

* ``ClusterLookup``: learned centroids (``cluster_probe.clusters``), cosine
  inner products; one-hot argmax when ``alpha`` is None, else
  softmax(ip * alpha); the cluster loss is ``-(probs * ip).sum(1).mean()``;
  the log-softmax of ``ip * alpha`` serves the CRF eval path;
* the linear probe is a 1x1 ``nn.Conv2d`` (``linear_probe.weight``);
* the decoder of the (default-off) reconstruction loss is a 1x1 conv
  dim -> n_feats (``decoder.weight``); ``FullDecoder`` is the reference's
  standalone ``Decoder`` module.

Inits draw from the caller's ``torch.Generator`` alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from depthg_tpu_torch.models.layers import conv1x1
from depthg_tpu_torch.ops.correlation import norm
from depthg_tpu_torch.ops.resize import resize_bilinear, resized_sq_norm


class ClusterLookup(nn.Module):
    def __init__(self, dim: int, n_classes: int):
        super().__init__()
        self.clusters = nn.Parameter(torch.zeros(n_classes, dim))


@torch.no_grad()
def conv1x1_init_(conv: nn.Conv2d, generator: torch.Generator) -> nn.Conv2d:
    """torch's default ``nn.Conv2d(in, out, 1)`` init, U(+-1/sqrt(in)) for
    weight and bias, drawn from ``generator``."""
    bound = conv.in_channels ** -0.5
    conv.weight.uniform_(-bound, bound, generator=generator)
    conv.bias.uniform_(-bound, bound, generator=generator)
    return conv


@torch.no_grad()
def cluster_lookup_init_(probe: ClusterLookup, generator: torch.Generator) -> ClusterLookup:
    """Standard-normal centroids."""
    probe.clusters.normal_(generator=generator)
    return probe


def cluster_lookup_apply(clusters: torch.Tensor, x: torch.Tensor,
                         alpha: float | None, normalized: bool = True,
                         log_probs: bool = True):
    """x: [B, dim, H, W]. ``log_probs=True`` (the eval side): cluster
    log-probs, or with ``normalized=False`` the raw ``ip * alpha`` logits,
    which are shift-equivalent for softmax/argmax consumers.
    ``log_probs=False`` (the training side): (loss, probs), the probs a
    one-hot argmax without gradient when ``alpha`` is None."""
    ip = torch.einsum("bchw,nc->bnhw", norm(x.float(), dim=1),
                      norm(clusters.float(), dim=1))
    if log_probs:
        if alpha is None:
            raise ValueError("log_probs=True needs alpha")
        return ip * alpha if not normalized else torch.log_softmax(ip * alpha, dim=1)
    if alpha is None:
        probs = F.one_hot(ip.argmax(dim=1), clusters.shape[0]).permute(0, 3, 1, 2).float()
    else:
        probs = torch.softmax(ip * alpha, dim=1)
    return -(probs * ip).sum(1).mean(), probs


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


def linear_probe_apply(probe: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The 1x1-conv classifier."""
    return probe(x)


class FullDecoder(nn.Module):
    """A linear 1x1 conv plus a conv-relu-conv-relu-conv branch, summed."""

    def __init__(self, code_ch: int, feat_ch: int):
        super().__init__()
        self.linear = conv1x1(code_ch, feat_ch)
        self.nonlinear = nn.Sequential(conv1x1(code_ch, code_ch), nn.ReLU(),
                                       conv1x1(code_ch, code_ch), nn.ReLU(),
                                       conv1x1(code_ch, feat_ch))

    def init_weights(self, generator: torch.Generator) -> "FullDecoder":
        for conv in (self.linear, self.nonlinear[0], self.nonlinear[2], self.nonlinear[4]):
            conv1x1_init_(conv, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x) + self.nonlinear(x)


def resize_and_classify(probe: nn.Conv2d, x: torch.Tensor, size) -> torch.Tensor:
    """The reference ``ResizeAndClassify``: 1x1-conv predictor, log-softmax,
    bilinear upsample."""
    return resize_bilinear(torch.log_softmax(probe(x), dim=1), size)
