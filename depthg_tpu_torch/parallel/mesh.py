"""Devices of one process for replicated inference (the in-process half of
``depthg_tpu/parallel/mesh.py``): the HTTP service keeps one replica of
the model per device and splits each padded batch evenly across them, as
the JAX service shards a batch over its mesh."""

from __future__ import annotations

import copy

import torch
from torch import nn


def make_devices(n_devices: int, device: str = "cuda") -> list[torch.device]:
    """The first ``n_devices`` visible CUDA devices (raises when fewer
    exist), or ``n_devices`` copies of the CPU for ``device="cpu"``."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be at least 1, got {n}")
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > avail:
        raise RuntimeError(f"n_devices={n} but {avail} CUDA device(s) are visible")
    return [torch.device("cuda", i) for i in range(n)]


def replicate(module: nn.Module, devices) -> list[nn.Module]:
    """One copy of ``module`` per device, all with its weights; the first
    is ``module`` itself, moved. The copies are made on each device's
    current stream; every device is synchronized once, so a replica read
    on a stream of its own meets its weights written."""
    out = []
    for i, dev in enumerate(devices):
        m = module if i == 0 else copy.deepcopy(module)
        out.append(m.to(dev).eval())
    for dev in {torch.device(d) for d in devices}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out
