"""Masked non-causal softmax attention: Hopper kernel + its plain version.

Replaces the TPU kernels ``depthg_tpu/ops/attention.py:whole_kv_mha_qkv``
(packed qkv, head pairs), ``whole_kv_mha`` (split operands, for head
counts that do not pair) and ``depthg_tpu/models/vit.py:_flash_mha``
(Pallas flash attention with segment ids) with ONE CUDA kernel,
``csrc/attention.cu``, which reads q, k and v through (batch, head, token)
strides and writes token-major [B, N, D] directly, so neither relayout
exists. ``attention_qkv`` takes any head count, so the split-operand entry
the TPU needed for odd head counts has no counterpart here.

Contract (``_attend`` of the JAX package): ``softmax(q k^T * scale + bias) v``
with q*scale rounded to the input dtype, fp32 logits and accumulation, the
row sum clamped at 1e-30 and applied to the output; keys j >= n_valid weigh
exactly 0 and query rows i >= n_valid come out exactly 0. The optional
``bias`` is one [N, N] logit bias per head ([H, N, N], BEiT's
relative-position bias, the same for every image), read in its own dtype
(bf16 or float32) and added in float32 after the scale, before the mask and
the row max; what it holds at keys or rows >= n_valid is never used.

What bounds the kernel on an H100 and what its design does about it is in
the header of ``csrc/attention.cu`` (bf16: TMA loads, ``wgmma`` products,
the softmax overlapped with them; float32: the same shape on split TF32
operands, hi + lo, three ``wgmma`` products each, after a pack kernel that
writes k and v split into a workspace the wrapper allocates with the size
``depthg_attention_workspace_bytes`` gives). The bf16 kernel's
entry makes its TMA tensor maps from the pointers and strides it is given, so
a view needs a 16-byte aligned base and positive strides that are multiples
of 16 bytes. The kernel reads a bias in pairs of adjacent keys, so a bias
needs a contiguous last axis, head and row strides that are positive
multiples of 8 elements and a 16-byte aligned base (BEiT builds it as [H, N, round_up(N, 8)]
and passes the [:, :, :N] view); ``attention_plain`` takes any bias. The
wrappers here:

* CUDA tensor -> the kernel, or an exception (bad shape, dtype, stride,
  alignment, build or launch). There is no fallback.
* CPU tensor -> ``attention_plain``, the eager version of the same math.
* The kernel has no backward (the JAX package has none either: its
  fine-tune trains through the einsum path). On CUDA a call that would
  need a gradient through it (grad mode on and ``qkv`` or the bias
  requiring one) raises instead of returning a result without a
  ``grad_fn``; a caller that trains passes ``attn_impl="xla"``.
* ``KERNEL.launches`` counts kernel launches (one per call, all heads and
  images, with or without a bias), so a run can show that it went through
  the kernel; ``KERNEL.bias_launches`` counts those that carried a bias,
  ``KERNEL.f32_launches`` those of the float32 kernel.
"""

from __future__ import annotations

import ctypes
import threading
import types

import torch

from depthg_tpu_torch.ops import _build

HEAD_DIM = 64


class _AttentionKernel:
    """The compiled library (built on first CUDA call) and its launch count."""

    def __init__(self):
        self.launches = 0
        self.bias_launches = 0
        self.f32_launches = 0
        self._fns = None
        # the service's replicas launch from one thread each
        self._lock = threading.Lock()

    def count(self, bias: bool, bf16: bool) -> None:
        with self._lock:
            self.launches += 1
            self.bias_launches += bias
            self.f32_launches += not bf16

    def fn(self):
        """The entries of ``csrc/attention.cu``: ``fwd`` and ``workspace_bytes``."""
        with self._lock:
            if self._fns is None:
                lib = _build.load("attention")
                fwd = lib.depthg_attention_fwd
                fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                                + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_int]
                                + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                        ctypes.c_void_p, ctypes.c_void_p])
                fwd.restype = ctypes.c_int
                ws = lib.depthg_attention_workspace_bytes
                ws.argtypes = [ctypes.c_int] * 4
                ws.restype = ctypes.c_longlong
                self._fns = types.SimpleNamespace(fwd=fwd, workspace_bytes=ws)
            return self._fns


KERNEL = _AttentionKernel()


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, n_valid: int | None = None,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Eager reference of the kernel on [B, H, N, HD] -> [B, H, N, HD], with
    an optional [H, N, N] logit bias (any float dtype, any strides)."""
    n = q.shape[2]
    nv = n if n_valid is None else int(n_valid)
    qs = (q.float() * scale).to(q.dtype).float()
    s = torch.einsum("bhnd,bhmd->bhnm", qs, k.float())
    if bias is not None:
        s = s + bias.float()
    keep = torch.arange(n, device=q.device) < nv
    s = s.masked_fill(~keep, float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    vz = v.float().masked_fill(~keep[:, None], 0.0)  # masked keys weigh exactly 0
    o = torch.einsum("bhnm,bhmd->bhnd", e.to(v.dtype).float(), vz) / l
    o = o.masked_fill(~keep[:, None], 0.0)  # padded query rows exactly 0
    return o.to(q.dtype)


def _check(q, k, v, n_valid, bias=None):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention needs q/k/v of one [B, H, N, {HEAD_DIM}] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"attention kernel supports head_dim {HEAD_DIM}, "
                         f"got {q.shape[-1]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32,
                                                              torch.bfloat16):
        raise ValueError(f"attention needs float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    n = q.shape[2]
    nv = n if n_valid is None else int(n_valid)
    if not 1 <= nv <= n:
        raise ValueError(f"n_valid must be in [1, {n}], got {nv}")
    if bias is not None:
        h = q.shape[1]
        if tuple(bias.shape) != (h, n, n):
            raise ValueError(f"bias must be [{h}, {n}, {n}], got {tuple(bias.shape)}")
        if bias.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"bias must be float32 or bfloat16, got {bias.dtype}")
        if bias.device != q.device:
            raise ValueError(f"bias on {bias.device}, q on {q.device}")
    return nv


def _launch(q, k, v, out, scale: float, nv: int, bias=None):
    """Launch the kernel on [B, H, N, 64] views (``out`` may be a view) with
    an optional [H, N, N] bias view."""
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel needs CUDA tensors, got {q.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (q, k, v, bias)):
        raise RuntimeError("attention kernel has no backward (as in the JAX package), so "
                           "a gradient through it would be lost: run the eager path "
                           "(attn_impl=\"xla\") with gradients on, or call it under "
                           "torch.no_grad()")
    bias_args = (None, 0, 0, 0)
    if bias is not None:
        # read in pairs of adjacent keys straight from the caller's view
        if (bias.stride(-1) != 1 or bias.stride(1) <= 0 or bias.stride(1) % 8
                or bias.stride(0) <= 0 or bias.stride(0) % 8 or bias.data_ptr() % 16):
            raise ValueError(f"attention kernel needs a bias with a contiguous last "
                             f"axis, head and row strides that are positive multiples "
                             f"of 8 and a 16-byte aligned base; got strides "
                             f"{bias.stride()}, base {bias.data_ptr() % 16} bytes "
                             f"past 16")
        # pairs are read up to column round_up(N, 2) - 1 of the last row
        h_, n_ = bias.shape[:2]
        end = (bias.storage_offset() + (h_ - 1) * bias.stride(0)
               + (n_ - 1) * bias.stride(1) + n_ + n_ % 2)
        if end * bias.element_size() > bias.untyped_storage().nbytes():
            raise ValueError("attention kernel needs a bias whose storage holds an even "
                             "number of columns in its last row (a view of padded rows)")
        bias_args = (bias.data_ptr(), bias.stride(0), bias.stride(1),
                     1 if bias.dtype == torch.bfloat16 else 2)
    itemsize = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(-1) != 1:
            raise ValueError(f"attention kernel needs a contiguous head_dim; "
                             f"{name} has strides {t.stride()}")
        # the bf16 kernel reads q, k and v through TMA tensor maps: a 16-byte
        # aligned base and strides that are positive multiples of 16 bytes
        if t.data_ptr() % 16 or any((s * itemsize) % 16 for s in t.stride()[:3]):
            raise ValueError(f"attention kernel needs 16-byte aligned rows; "
                             f"{name} has strides {t.stride()}")
        if any(s <= 0 for s in t.stride()[:3]):
            raise ValueError(f"attention kernel needs positive strides; "
                             f"{name} has strides {t.stride()}")
    b, h, n, _ = q.shape
    if n >= 2 ** 31 // 2:
        raise ValueError(f"sequence too long for the kernel: {n}")
    fns = KERNEL.fn()
    bf16 = q.dtype == torch.bfloat16
    # the float32 kernel's split k and v (their layout is the kernel's own);
    # freed on return, the memory is reused only by work queued after the
    # kernel on this stream
    ws = torch.empty(fns.workspace_bytes(b, h, nv, int(bf16)), dtype=torch.uint8,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fns.fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                      *out.stride()[:3], *bias_args, b, h, n, nv, float(scale),
                      int(bf16), ws.data_ptr() or None, stream)
    if err == 10000:
        raise RuntimeError("attention kernel: libcuda.so.1 has no "
                           "cuTensorMapEncodeTiled (or could not be loaded)")
    if err > 10000:
        raise RuntimeError(f"attention kernel: libcuda refused a tensor map for "
                           f"shape {tuple(q.shape)} (CUresult {err - 10000})")
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    KERNEL.count(bias is not None, bf16)
    return out


def split_qkv(qkv: torch.Tensor, num_heads: int):
    """[B, N, 3D] packed projection -> q, k, v views [B, H, N, D/H]."""
    b, n, d3 = qkv.shape
    if d3 % (3 * num_heads):
        raise ValueError(f"qkv last axis {d3} does not factor as 3 x "
                         f"{num_heads} heads")
    x = qkv.view(b, n, 3, num_heads, d3 // (3 * num_heads))
    return (x[:, :, i].permute(0, 2, 1, 3) for i in range(3))


def attention_qkv(qkv: torch.Tensor, num_heads: int, scale: float,
                  n_valid: int | None = None,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """Packed qkv [B, N, 3D] (K1 ``whole_kv_mha_qkv``) -> token-major [B, N, D],
    with an optional [H, N, N] logit bias.

    The kernel reads each head straight out of ``qkv`` through strides and
    writes its [N, 64] slice of the [B, N, D] output in place."""
    if qkv.dim() != 3:
        raise ValueError(f"attention_qkv needs [B, N, 3D], got {tuple(qkv.shape)}")
    q, k, v = split_qkv(qkv, num_heads)
    nv = _check(q, k, v, n_valid, bias)
    b, n, d3 = qkv.shape
    if qkv.device.type == "cpu":
        out = attention_plain(q, k, v, scale, nv, bias)
        return out.permute(0, 2, 1, 3).reshape(b, n, d3 // 3)
    out = torch.empty((b, n, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    _launch(q, k, v, out.view(b, n, num_heads, -1).permute(0, 2, 1, 3),
            scale, nv, bias)
    return out
