"""DINOv2's SwiGLU gate, ``silu(a) * b`` over the two halves of ``w12``'s
output: Hopper kernel + its plain version.

It replaces no TPU kernel: the JAX package has no DINOv2. The gate sits
between ``models.vit.SwiGLU``'s two products, which stay plain large
matrix products (``F.linear``, or ``W8A8Linear`` in the int8 copy).

* ``swiglu_gate_plain``: the module's eager code, ``F.silu(a) * b`` with
  ``a, b = h.chunk(2, dim=-1)``, on any device, dtype and width, with or
  without gradients.
* ``swiglu_gate``: a tensor off CUDA (the CPU's) takes the plain version;
  a CUDA tensor launches ``csrc/swiglu.cu`` (one read of ``h``, one write
  of the [..., H] output) or raises ValueError: bf16 or float32, H a
  multiple of 8, row-contiguous and 16-byte aligned, not requiring grad
  (the backbone is frozen). There is no fallback. The kernel rounds where the eager pair
  rounds, so it returns the plain version's bits (the header of
  ``csrc/swiglu.cu``).
* ``KERNEL.gate_launches`` counts the kernel's launches; the spans record
  it as ``swiglu_gate_launches``.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from depthg_tpu_torch.ops import _build
from depthg_tpu_torch.utils import profiling

# the device type whose tensors the kernel takes
DEVICE_TYPE = "cuda"
# the C entry's dtype codes
DTYPES = {torch.bfloat16: 0, torch.float32: 1}


class _GateKernel:
    """The compiled library (built on first CUDA call) and its launch count."""

    def __init__(self):
        self.gate_launches = 0
        self._fn = None
        # the service's replicas launch from one thread each
        self._lock = threading.Lock()

    def count(self) -> None:
        with self._lock:
            self.gate_launches += 1

    def fn(self):
        """The C entry ``depthg_swiglu_gate``."""
        with self._lock:
            if self._fn is None:
                fn = _build.load("swiglu").depthg_swiglu_gate
                fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn


KERNEL = _GateKernel()
profiling.register_counter("swiglu_gate_launches", lambda: KERNEL.gate_launches)


def swiglu_gate_plain(h: torch.Tensor) -> torch.Tensor:
    """[..., H] ``silu(a) * b`` of ``h`` [..., 2H], [a, b] its halves."""
    a, b = h.chunk(2, dim=-1)
    return F.silu(a) * b


def _check(h: torch.Tensor) -> None:
    """Raises ValueError on anything the kernel does not take (its device
    aside)."""
    if h.dtype not in DTYPES:
        raise ValueError(f"SwiGLU gate kernel takes bf16 or float32, got {h.dtype}")
    if h.requires_grad:
        raise ValueError("SwiGLU gate kernel has no backward: the input requires grad")
    if h.dim() < 1 or h.shape[-1] % 2:
        raise ValueError(f"SwiGLU gate needs an even last dimension, got {tuple(h.shape)}")
    if h.shape[-1] // 2 % 8:
        raise ValueError(f"SwiGLU gate kernel needs a half width H that is a multiple of 8, "
                         f"got H = {h.shape[-1] // 2}")
    if not h.is_contiguous():
        raise ValueError(f"SwiGLU gate kernel needs a row-contiguous input, got strides "
                         f"{h.stride()} for {tuple(h.shape)}")
    if h.data_ptr() % 16:
        raise ValueError("SwiGLU gate kernel needs a 16-byte aligned input")
    vectors = h.numel() * h.element_size() // 32  # the output's 16-byte vectors
    if not 1 <= vectors < 2 ** 31:
        raise ValueError(f"SwiGLU gate kernel takes 1 to 2^31 - 1 output vectors of 16 bytes, "
                         f"got {tuple(h.shape)}")


def swiglu_gate(h: torch.Tensor) -> torch.Tensor:
    """``swiglu_gate_plain(h)``: the plain version on the CPU, one kernel
    launch on a CUDA tensor (the kernel's terms above, else ValueError)."""
    if h.device.type != DEVICE_TYPE:
        return swiglu_gate_plain(h)
    _check(h)
    hidden = h.shape[-1] // 2
    out = torch.empty((*h.shape[:-1], hidden), dtype=h.dtype, device=h.device)
    fn = KERNEL.fn()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(h.data_ptr(), out.data_ptr(), h.numel() // h.shape[-1], hidden,
                 DTYPES[h.dtype], stream)
    if err != 0:
        raise RuntimeError(f"SwiGLU gate kernel launch failed for {tuple(h.shape)}: "
                           f"CUDA error {err}")
    KERNEL.count()
    return out
