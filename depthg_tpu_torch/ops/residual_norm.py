"""The ViT block's residual junction, ``x + gamma * y`` and the next
LayerNorm, read and written once: Hopper kernel + its plain versions.

It replaces no TPU kernel: the JAX package leaves these passes to XLA.
``models.vit``'s blocks and final norm call it (``Block``,
``LayerScaleBlock``, ``VisionTransformer.final_norm``).

* The plain versions are the eager expressions they replace, on any
  device, dtype and width, with or without gradients:
  ``residual_add_plain`` is ``x + y * gamma`` (``LayerScale`` and the
  block's add; ``x + y`` without ``gamma``), ``layer_norm_plain`` is
  ``models.layers.LayerNorm``'s forward (float32 in, the input dtype out),
  ``residual_norm_plain`` both.
* ``residual_norm(x, y, gamma, weight, bias, eps)`` -> ``(s, LN(s))`` with
  ``s = x + gamma * y``, ``residual_add(x, y, gamma)`` -> ``s`` and
  ``layer_norm(x, weight, bias, eps)``: a tensor off CUDA (the CPU's) takes
  the plain version; a CUDA tensor launches ``csrc/residual_norm.cu`` once
  or raises ValueError: bf16 or float32 with every tensor of ``x``'s dtype
  (eager would promote), D = ``x.shape[-1]`` a multiple of 64 up to
  2,048 (every ViT preset's width), row-contiguous and 16-byte aligned,
  nothing that requires grad while gradients are on (the backbone runs
  under ``torch.no_grad``). There is no fallback. ``s`` is the plain
  version's bits; the norm differs from ``F.layer_norm`` only in the order
  of its float32 sums (the header of ``csrc/residual_norm.cu``). Outputs
  are fresh tensors. ``_check`` is the one statement of what it takes.
* ``KERNEL.launches`` counts the kernel's launches; the spans record it as
  ``residual_norm_launches``.
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
# the widths it takes: multiples of WIDTH_STEP up to MAX_WIDTH (a warp holds a row)
WIDTH_STEP, MAX_WIDTH = 64, 2048


class _JunctionKernel:
    """The compiled library (built on first CUDA call) and its launch count."""

    def __init__(self):
        self.launches = 0
        self._fn = None
        # the service's replicas launch from one thread each
        self._lock = threading.Lock()

    def count(self) -> None:
        with self._lock:
            self.launches += 1

    def fn(self):
        """The C entry ``depthg_residual_norm``."""
        with self._lock:
            if self._fn is None:
                fn = _build.load("residual_norm").depthg_residual_norm
                fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                                        ctypes.c_float, ctypes.c_int,
                                                        ctypes.c_int, ctypes.c_void_p])
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn


KERNEL = _JunctionKernel()
profiling.register_counter("residual_norm_launches", lambda: KERNEL.launches)


def residual_add_plain(x: torch.Tensor, y: torch.Tensor,
                       gamma: torch.Tensor | None) -> torch.Tensor:
    """``x + y * gamma`` (``x + y`` without ``gamma``), as eager rounds it."""
    return x + (y if gamma is None else y * gamma)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """``models.layers.LayerNorm``: float32 over the last dimension, returned
    in ``x``'s dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(),
                        eps).to(x.dtype)


def residual_norm_plain(x, y, gamma, weight, bias, eps):
    """``(s, layer_norm_plain(s))`` with ``s = residual_add_plain(x, y, gamma)``."""
    s = residual_add_plain(x, y, gamma)
    return s, layer_norm_plain(s, weight, bias, eps)


def _check(x, y, gamma, weight, bias) -> None:
    """Raises ValueError on anything the kernel does not take (the device
    type of ``x`` aside). One pass over the tensors: a junction launches
    three times a block, and the host paces the small steps."""
    dtype, device = x.dtype, x.get_device()
    if dtype not in DTYPES:
        raise ValueError(f"residual junction kernel takes bf16 or float32, got {dtype}")
    d = x.shape[-1] if x.dim() else 0
    if not (d % WIDTH_STEP == 0 and 0 < d <= MAX_WIDTH):
        raise ValueError(f"residual junction kernel needs a width that is a multiple of "
                         f"{WIDTH_STEP} up to {MAX_WIDTH}, got {tuple(x.shape)}")
    if not 1 <= x.numel() // d < 2 ** 31:
        raise ValueError(f"residual junction kernel takes 1 to 2^31 - 1 rows, got "
                         f"{tuple(x.shape)}")
    grad = torch.is_grad_enabled()
    for name, t, shape in (("x", x, x.shape), ("y", y, x.shape), ("gamma", gamma, (d,)),
                           ("weight", weight, (d,)), ("bias", bias, (d,))):
        if t is None:
            continue
        if t.dtype != dtype:
            raise ValueError(f"residual junction kernel needs one dtype: x is {dtype}, "
                             f"{name} is {t.dtype} (eager would promote)")
        if t.get_device() != device:
            raise ValueError(f"residual junction tensors must be on one device; {name} is "
                             f"on {t.device}, x on {x.device}")
        if grad and t.requires_grad:
            raise ValueError(f"residual junction kernel has no backward: {name} requires grad "
                             f"while gradients are on")
        if t.shape != shape:
            raise ValueError(f"residual junction needs {name} of shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"residual junction kernel needs row-contiguous tensors; {name} "
                             f"has strides {t.stride()} for {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"residual junction kernel needs 16-byte aligned tensors; "
                             f"{name} is not")


def _launch(x, y, gamma, weight, bias, eps, residual: bool, normed: bool):
    """One launch: (s or None, LN or None)."""
    if (residual and y is None) or (normed and (weight is None or bias is None)):
        raise ValueError("residual junction kernel needs y for the residual and weight and "
                         "bias for the norm")
    _check(x, y, gamma, weight, bias)
    # x is contiguous (checked), so are its likes
    out_x = torch.empty_like(x) if residual else None
    out_n = torch.empty_like(x) if normed else None
    d, device = x.shape[-1], x.get_device()

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = KERNEL._fn or KERNEL.fn()
    err = fn(x.data_ptr(), ptr(y), ptr(gamma), ptr(weight), ptr(bias), ptr(out_x), ptr(out_n),
             x.numel() // d, d, float(eps), DTYPES[x.dtype], device,
             torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"residual junction kernel launch failed for {tuple(x.shape)}: "
                           f"CUDA error {err}")
    KERNEL.count()
    return out_x, out_n


def residual_norm(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor | None,
                  weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """``residual_norm_plain(...)``: the plain version on the CPU, one kernel
    launch on a CUDA tensor (the kernel's terms above, else ValueError)."""
    if x.device.type != DEVICE_TYPE:
        return residual_norm_plain(x, y, gamma, weight, bias, eps)
    return _launch(x, y, gamma, weight, bias, eps, residual=True, normed=True)


def residual_add(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor | None) -> torch.Tensor:
    """``residual_add_plain(...)``, as ``residual_norm`` routes it."""
    if x.device.type != DEVICE_TYPE:
        return residual_add_plain(x, y, gamma)
    return _launch(x, y, gamma, None, None, 0.0, residual=True, normed=False)[0]


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """``layer_norm_plain(...)``, as ``residual_norm`` routes it."""
    if x.device.type != DEVICE_TYPE:
        return layer_norm_plain(x, weight, bias, eps)
    return _launch(x, None, None, weight, bias, eps, residual=False, normed=True)[1]
