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
* ``KERNEL.launches`` counts kernel launches (one per call, whole batch);
  ``KERNEL.f32_launches`` those of the float32 message.
* ``bilateral_cache_int8`` builds the CRF's int8 kernel cache (fixed scale
  127, round half to even, ``ops/crf.cache_kernel_int8``) from the same
  features in one launch for the whole batch: each entry is computed as the
  message computes it and written once as a byte. CUDA tensors only (the
  CRF builds its cache eagerly on the CPU); ``KERNEL.cache_launches``
  counts its launches, which ``KERNEL.launches`` does not (the spans record
  them as ``crf_cache_launches``).
* ``int8_message`` is the CRF's message through that cache, ``K8 @ z`` with
  z quantized per image (``int8_message_plain`` has the arithmetic): on
  CUDA one quantize and one product launch for the batch, any N, bit for
  bit the float32 arithmetic of the plain version's eager ops on the card
  (the int32 sums are exact); ``KERNEL.message_launches`` counts its calls
  on CUDA (the spans record them as ``crf_message_launches``).

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
from depthg_tpu_torch.utils import profiling

N_FEATURES = 5
# entries of one [B, rows, N] block of kernel entries, in the plain version
# and in the CRF's bf16/f32 cache build (``ops/crf._cache_kernel``)
BLOCK_ELEMS = 2 ** 26


class _BilateralKernel:
    """The compiled library (built on first CUDA call) and its launch count."""

    def __init__(self):
        self.launches = 0
        self.f32_launches = 0
        self.cache_launches = 0
        self.message_launches = 0
        self._fns = None
        # the service's replicas launch from one thread each
        self._lock = threading.Lock()

    def count(self, bf16: bool = True) -> None:
        with self._lock:
            self.launches += 1
            self.f32_launches += not bf16

    def count_cache(self) -> None:
        with self._lock:
            self.cache_launches += 1

    def count_message(self) -> None:
        with self._lock:
            self.message_launches += 1

    def fn(self):
        """The entries of ``csrc/crf_bilateral.cu``: ``bf16`` and ``f32``
        messages, ``degree``, ``cache_int8``, ``workspace_bytes``,
        ``int8_message`` and ``int8_workspace_bytes``."""
        with self._lock:
            if self._fns is None:
                lib = _build.load("crf_bilateral")
                fns = types.SimpleNamespace(
                    bf16=lib.depthg_bilateral_message_bf16,
                    f32=lib.depthg_bilateral_message_f32,
                    degree=lib.depthg_bilateral_degree,
                    cache_int8=lib.depthg_bilateral_cache_int8,
                    workspace_bytes=lib.depthg_bilateral_workspace_bytes,
                    int8_message=lib.depthg_int8_message,
                    int8_workspace_bytes=lib.depthg_int8_message_workspace_bytes)
                for f in (fns.bf16, fns.f32):
                    f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6
                                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
                    f.restype = ctypes.c_int
                fns.degree.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4
                                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
                fns.degree.restype = ctypes.c_int
                fns.cache_int8.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                                           + [ctypes.c_int] * 2 + [ctypes.c_void_p])
                fns.cache_int8.restype = ctypes.c_int
                fns.workspace_bytes.argtypes = [ctypes.c_int] * 4
                fns.workspace_bytes.restype = ctypes.c_longlong
                fns.int8_message.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                                             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
                fns.int8_message.restype = ctypes.c_int
                fns.int8_workspace_bytes.argtypes = [ctypes.c_int] * 3
                fns.int8_workspace_bytes.restype = ctypes.c_longlong
                self._fns = fns
            return self._fns


KERNEL = _BilateralKernel()
profiling.register_counter("crf_cache_launches", lambda: KERNEL.cache_launches)
profiling.register_counter("crf_message_launches", lambda: KERNEL.message_launches)


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


def bilateral_cache_int8(feats: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """[B, N, 5] float32 CUDA features -> [B, N, N] int8 kernel cache,
    round_half_even(127 exp(-|f_i - f_j|^2 / 2)), one launch; written into
    ``out`` (contiguous, 16-byte aligned, on the features' device) when
    given."""
    _check_feats(feats)
    b, n, _ = feats.shape
    if feats.device.type != "cuda":
        raise ValueError(f"int8 cache kernel needs CUDA tensors, got {feats.device}")
    if max(b, n) >= 2 ** 31:
        raise ValueError(f"shape too large for the kernel: {tuple(feats.shape)}")
    if out is None:
        out = torch.empty((b, n, n), dtype=torch.int8, device=feats.device)
    elif (out.device != feats.device or out.shape != (b, n, n) or out.dtype != torch.int8
            or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous, 16-byte aligned [{b}, {n}, {n}] int8 "
                         f"tensor on {feats.device}, got {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} at {out.data_ptr():#x}")
    if feats.stride(-1) != 1:
        feats = feats.contiguous()
    fns = KERNEL.fn()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = fns.cache_int8(feats.data_ptr(), out.data_ptr(), *feats.stride()[:2], b, n,
                             stream)
    if err != 0:
        raise RuntimeError(f"int8 cache kernel launch failed for {tuple(feats.shape)}: "
                           f"CUDA error {err}")
    KERNEL.count_cache()
    return out


# the int8 message's dtypes, and its largest N: N 128 127 < 2^31 keeps the
# int32 sums from overflowing
INT8_DTYPES = (torch.float32, torch.bfloat16)
INT8_MAX_N = 132_104


def int8_message_plain(kmat: torch.Tensor, z: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """[B, N, N] int8 @ [B, N, C] -> [B, N, C] in ``dt``: z quantized per
    image with the dynamic scale zmax / 127 (round half to even), the product
    in float64, which is exact here (|sum| <= N 128 127 < 2^53), rescaled by
    zmax / 127^2. Any device: on the card these eager ops give the kernel's
    bits."""
    zmax = z.abs().amax(dim=(1, 2), keepdim=True).float().clamp_min(1e-20)
    z8 = torch.round(z.float() * (127.0 / zmax)).to(torch.int8)
    return (torch.bmm(kmat.double(), z8.double()).float() * (zmax / (127.0 * 127.0))).to(dt)


def _check_int8(kmat, z, dt):
    if kmat.dtype != torch.int8 or kmat.dim() != 3 or kmat.shape[1] != kmat.shape[2]:
        raise ValueError(f"int8 message needs an int8 cache [B, N, N], got "
                         f"{tuple(kmat.shape)} {kmat.dtype}")
    if z.dim() != 3 or z.shape[:2] != kmat.shape[:2] or z.shape[1] < 1 or z.shape[2] < 1:
        raise ValueError(f"int8 message needs z [B, N, C >= 1] matching the cache "
                         f"{tuple(kmat.shape)}, got {tuple(z.shape)}")
    if z.dtype not in INT8_DTYPES or dt not in INT8_DTYPES:
        raise ValueError(f"int8 message needs z and its result in float32 or bfloat16, got "
                         f"{z.dtype} -> {dt}")
    if z.device != kmat.device:
        raise ValueError("the cache and z must be on one device")
    if kmat.shape[1] > INT8_MAX_N:
        raise ValueError(f"int8 message takes N <= {INT8_MAX_N} (int32 sums), got "
                         f"{kmat.shape[1]}")


def _rows_contiguous(t):
    """Whether the kernels can read t [B, N, C] through its image and point
    strides alone: its last axis contiguous (or of one element)."""
    return t.stride(-1) == 1 or t.shape[-1] == 1


def _launch_int8(kmat, z, out):
    """Launch the quantize and product kernels: the contiguous cache, z and
    out [B, N, C] views with a contiguous last axis, the result in out's
    dtype."""
    if not kmat.is_contiguous():
        raise ValueError(f"int8 message needs a contiguous cache, got strides {kmat.stride()}")
    if (not _rows_contiguous(z) or not _rows_contiguous(out) or out.shape != z.shape
            or out.dtype not in INT8_DTYPES or out.device != z.device):
        raise ValueError(f"int8 message needs z and out [B, N, C] on one device with a "
                         f"contiguous last axis, got {tuple(z.shape)} {z.stride()} and "
                         f"{tuple(out.shape)} {out.stride()} {out.dtype}")
    b, n, c = z.shape
    fns = KERNEL.fn()
    # the quantized operand and the rescale factors (their layout is the kernel's own)
    ws = torch.empty(fns.int8_workspace_bytes(b, n, c), dtype=torch.uint8, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = fns.int8_message(kmat.data_ptr(), z.data_ptr(), out.data_ptr(), ws.data_ptr(),
                               *z.stride()[:2], *out.stride()[:2], b, n, c,
                               z.dtype == torch.bfloat16, out.dtype == torch.bfloat16, stream)
    if err != 0:
        raise RuntimeError(f"int8 message launch failed for {tuple(z.shape)}: CUDA error {err}")
    KERNEL.count_message()
    return out


def int8_message(kmat: torch.Tensor, z: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The CRF's message through its int8 cache: kmat [B, N, N] int8 (entries
    at the scale 127), z [B, N, C] float32 or bf16 -> [B, N, C] in ``dt``
    (float32 or bf16). The kernels on CUDA tensors (two launches for the
    batch; the cache contiguous), the plain version on CPU ones."""
    _check_int8(kmat, z, dt)
    if kmat.device.type == "cpu":
        return int8_message_plain(kmat, z, dt)
    if not _rows_contiguous(z):
        z = z.contiguous()
    return _launch_int8(kmat, z, torch.empty(z.shape, dtype=dt, device=z.device))
