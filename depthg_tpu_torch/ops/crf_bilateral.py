"""Streaming bilateral message of the dense CRF: Hopper kernel + its plain
version.

Replaces the TPU kernel ``depthg_tpu/ops/crf_pallas.py:bilateral_message_pallas``
(K4), the fused form of ``depthg_tpu/ops/crf.py:_bilateral_message``:

    out[b] = K[b] @ values[b],  k_ij = exp(-|f_i - f_j|^2 / 2)

with feats [B, N, 5] float32 (x, y, r, g, b already divided by their
sigmas) and values [B, N, C] in bfloat16 or float32. The output is
[B, N, C] in the values' dtype, accumulated in float32. The kernel matrix
is never stored. The CRF runs this for every configuration whose kernel it
does not cache (``CRFConfig.kernel_cache_mb``): the exact ``downsample=1``
CRF, ``downsample=2`` with 2 or 4 phases, ``kernel_cache_mb=0``.

The log-kernel is ``-0.5 * sum_f (f_i - f_j)^2`` computed directly, in both
the kernel and ``bilateral_message_plain``: no cancellation, so the two agree
to float32 rounding. The JAX package computes it as ``a.b - |a|^2/2 -
|b|^2/2``, whose terms reach ~2e4 for pixel colors (rgb/3 ~ 85), so it
carries ~1e-3 of noise per entry that the port does not.

With bfloat16 values the kernel entries are rounded to bfloat16 as the
operand of the value product (tensor cores in the kernel; an explicit cast
in the plain version), as the JAX package's tile is returned in the values'
dtype. With float32 values the kernel takes the product on the tensor cores
as split TF32 (entry and value each hi + lo, three products: ~21 bits, held
to float32's limits), the plain version in float32.

* CUDA tensor -> the kernel ``csrc/crf_bilateral.cu``, or an exception (bad
  shape, dtype, build or launch). There is no fallback.
* CPU tensor -> ``bilateral_message_plain``.
* ``bilateral_degree`` is K @ 1 in float32 (the CRF's normalizer, once per
  call): the kernel's degree entry on CUDA tensors (row sums of the entries,
  no value product), the plain version on ones on the CPU.
* Both entries count their work from the shapes for
  ``utils.profiling.step_flops`` (``counted``), the same on both devices.
* ``KERNEL.launches`` counts kernel launches (one per call, whole batch);
  ``KERNEL.f32_launches`` those of the float32 message.

The TPU forms are not ported: the unrolled symmetric diagonals, the
+inf/-1e30 padding of the features and the VMEM budget check. Any N is
taken: the kernels read the caller's [B, N, *] tensors through their
strides and handle the ragged edge themselves (each entry packs its
operands into a workspace whose size and layout ``csrc/crf_bilateral.cu``
alone knows).
"""

from __future__ import annotations

import ctypes
import threading
import types

import torch

from depthg_tpu_torch.ops import _build
from depthg_tpu_torch.utils.profiling import (bilateral_degree_flops,
                                              bilateral_message_flops, counted)

N_FEATURES = 5
# entries of one [B, rows, N] block of kernel entries, in the plain version
# and in the CRF's bf16/f32 cache build (``ops/crf._cache_kernel``)
BLOCK_ELEMS = 2 ** 26


class _BilateralKernel:
    """The compiled library (built on first CUDA call) and its launch count."""

    def __init__(self):
        self.launches = 0
        self.f32_launches = 0
        self._fns = None
        # the service's replicas launch from one thread each
        self._lock = threading.Lock()

    def count(self, bf16: bool = True) -> None:
        with self._lock:
            self.launches += 1
            self.f32_launches += not bf16

    def fn(self):
        """The entries of ``csrc/crf_bilateral.cu``: ``bf16`` and ``f32``
        messages, ``degree`` and ``workspace_bytes``."""
        with self._lock:
            if self._fns is None:
                lib = _build.load("crf_bilateral")
                fns = types.SimpleNamespace(
                    bf16=lib.depthg_bilateral_message_bf16,
                    f32=lib.depthg_bilateral_message_f32,
                    degree=lib.depthg_bilateral_degree,
                    workspace_bytes=lib.depthg_bilateral_workspace_bytes)
                for f in (fns.bf16, fns.f32):
                    f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6
                                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
                    f.restype = ctypes.c_int
                fns.degree.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4
                                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
                fns.degree.restype = ctypes.c_int
                fns.workspace_bytes.argtypes = [ctypes.c_int] * 4
                fns.workspace_bytes.restype = ctypes.c_longlong
                self._fns = fns
            return self._fns


KERNEL = _BilateralKernel()


def row_blocks(b: int, n: int):
    """(start, stop) row ranges of [b, rows, n] blocks of ``BLOCK_ELEMS``."""
    rows = max(1, BLOCK_ELEMS // (b * n))
    return [(r0, min(r0 + rows, n)) for r0 in range(0, n, rows)]


def bilateral_message_plain(feats: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Eager version of the kernel, in row blocks of the [B, N, N] kernel."""
    b, n, _ = feats.shape
    f = feats.float()
    vf = values.float()
    out = torch.empty(values.shape, dtype=torch.float32, device=values.device)
    for r0, r1 in row_blocks(b, n):
        fi = f[:, r0:r1]
        d = torch.zeros((b, r1 - r0, n), dtype=torch.float32, device=f.device)
        for k in range(N_FEATURES):
            diff = fi[:, :, None, k] - f[:, None, :, k]
            d.addcmul_(diff, diff)
        kmat = torch.exp(-0.5 * d)
        if values.dtype == torch.bfloat16:
            kmat = kmat.to(torch.bfloat16).float()  # the kernel's P operand
        out[:, r0:r1] = torch.bmm(kmat, vf)
    return out.to(values.dtype)


def _check_feats(feats):
    if feats.dim() != 3 or feats.shape[-1] != N_FEATURES or feats.shape[1] < 1:
        raise ValueError(f"bilateral message needs feats [B, N >= 1, {N_FEATURES}], "
                         f"got {tuple(feats.shape)}")
    if feats.dtype != torch.float32:
        raise ValueError(f"bilateral message needs float32 feats, got {feats.dtype}")


def _check(feats, values):
    _check_feats(feats)
    if values.dim() != 3 or values.shape[:2] != feats.shape[:2]:
        raise ValueError(f"bilateral message needs values [B, N, C] matching "
                         f"feats {tuple(feats.shape)}, got {tuple(values.shape)}")
    if values.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bilateral message needs float32 or bfloat16 values, "
                         f"got {values.dtype}")
    if feats.device != values.device:
        raise ValueError("feats and values must be on one device")
    if values.shape[1] < 1 or values.shape[2] < 1:
        raise ValueError(f"bilateral message needs N >= 1 and C >= 1, got "
                         f"{tuple(values.shape)}")


# workspace modes of ``depthg_bilateral_workspace_bytes``
_WS_F32, _WS_BF16, _WS_DEGREE = 0, 1, 2


def _launch(feats, values, out):
    """Launch the kernel on [B, N, 5] / [B, N, C] views (last axes contiguous)."""
    if feats.device.type != "cuda":
        raise ValueError(f"bilateral kernel needs CUDA tensors, got {feats.device}")
    for name, t in (("feats", feats), ("values", values), ("out", out)):
        if t.stride(-1) != 1:
            raise ValueError(f"bilateral kernel needs a contiguous last axis; "
                             f"{name} has strides {t.stride()}")
    if out.shape != values.shape or out.dtype != values.dtype:
        raise ValueError("out must have the shape and dtype of values")
    b, n, c = values.shape
    if max(b, n, c) >= 2 ** 31:  # the C entries take int; they check the grid
        raise ValueError(f"shape too large for the kernel: {tuple(values.shape)}")
    fns = KERNEL.fn()
    bf16 = values.dtype == torch.bfloat16
    entry = fns.bf16 if bf16 else fns.f32
    # the kernel's packed operands (their layout is the kernel's own);
    # freed on return, the memory is reused only by work queued after the
    # kernel on this stream
    ws = torch.empty(fns.workspace_bytes(b, n, c, _WS_BF16 if bf16 else _WS_F32),
                     dtype=torch.uint8, device=values.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = entry(
            feats.data_ptr(), values.data_ptr(), out.data_ptr(), ws.data_ptr(),
            *feats.stride()[:2], *values.stride()[:2], *out.stride()[:2],
            b, n, c, stream)
    if err != 0:
        raise RuntimeError(f"bilateral kernel launch failed for {tuple(values.shape)}: "
                           f"CUDA error {err}")
    KERNEL.count(bf16)
    return out


@counted(lambda feats, values: bilateral_message_flops(*values.shape))
def bilateral_message(feats: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """K @ values per image: [B, N, 5] float32, [B, N, C] -> [B, N, C] in the
    values' dtype. The kernel on CUDA tensors, the plain version on CPU ones."""
    _check(feats, values)
    if feats.device.type == "cpu":
        return bilateral_message_plain(feats, values)
    if feats.stride(-1) != 1:
        feats = feats.contiguous()
    if values.stride(-1) != 1:
        values = values.contiguous()
    return _launch(feats, values, torch.empty(values.shape, dtype=values.dtype,
                                              device=values.device))


@counted(lambda feats: bilateral_degree_flops(*feats.shape[:2]))
def bilateral_degree(feats: torch.Tensor) -> torch.Tensor:
    """K @ 1 per image, float32: [B, N, 5] float32 -> [B, N, 1]."""
    _check_feats(feats)
    b, n, _ = feats.shape
    if feats.device.type == "cpu":
        return bilateral_message_plain(feats, torch.ones((b, n, 1)))
    if feats.stride(-1) != 1:
        feats = feats.contiguous()
    if max(b, n) >= 2 ** 31:
        raise ValueError(f"shape too large for the kernel: {tuple(feats.shape)}")
    fns = KERNEL.fn()
    out = torch.empty((b, n, 1), dtype=torch.float32, device=feats.device)
    ws = torch.empty(fns.workspace_bytes(b, n, 1, _WS_DEGREE), dtype=torch.uint8,
                     device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = fns.degree(feats.data_ptr(), out.data_ptr(), ws.data_ptr(),
                         *feats.stride()[:2], *out.stride()[:2], b, n, stream)
    if err != 0:
        raise RuntimeError(f"bilateral degree launch failed for {tuple(feats.shape)}: "
                           f"CUDA error {err}")
    KERNEL.count()
    return out
