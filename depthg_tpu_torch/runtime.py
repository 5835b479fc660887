"""Device choice and numeric switches for the PyTorch port, in one place.

The port never picks a device behind the caller's back: ``cuda`` is used
when asked for and present, otherwise :func:`get_device` raises. The CPU
runs only when the caller passes ``device="cpu"`` (the tests do).

TF32 is switched off for both matmuls and cuDNN convolutions: the dense
CRF's bilateral log-kernel ``a.b - |a|^2/2 - |b|^2/2`` is a cancellation
of O(1e3) terms that needs ~0.1 absolute accuracy, and TF32's ~3 decimal
digits destroy it the same way the TPU's default bf16 matmul pass did
(docs/CRF_FIDELITY.md, "History").
"""

from __future__ import annotations

import numpy as np
import torch


def configure_numerics() -> None:
    """Full-precision float32 matmuls and convolutions (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_off() -> bool:
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32)


def get_device(device: str | torch.device = "cuda") -> torch.device:
    """The device the caller named; raises if it is CUDA and none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    configure_numerics()
    return dev


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``; on CUDA through pinned memory
    with a non-blocking copy."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)

