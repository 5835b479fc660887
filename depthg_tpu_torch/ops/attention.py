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
of 16 bytes. Both kernels read a bias through a TMA tensor map too (its rows
and keys up to n_valid, nothing past them), so a bias needs a contiguous
last axis, head and row strides that are positive multiples of 8 elements
and a 16-byte aligned base (BEiT builds it as [H, N, round_up(N, 8)] and
passes the [:, :, :N] view); ``attention_plain`` takes any bias. The
wrappers here:

* CUDA tensor -> the kernel, or an exception (bad shape, dtype, stride,
  alignment, build or launch). There is no fallback.
* CPU tensor -> ``attention_plain``, the eager version of the same math.
* The kernel has no backward (the JAX package has none either: its
  fine-tune trains through the einsum path). On CUDA a call that would
  need a gradient through it (grad mode on and ``qkv`` or the bias
  requiring one) raises instead of returning a result without a
  ``grad_fn``; a caller that trains passes ``attn_impl="xla"``.
* ``attention_qkv`` counts its work from the shapes for
  ``utils.profiling.step_flops`` (``counted``), the same on both devices.
* ``KERNEL.launches`` counts kernel launches (one per call, all heads and
  images, with or without a bias), so a run can show that it went through
  the kernel; ``KERNEL.bias_launches`` counts those that carried a bias,
  ``KERNEL.f32_launches`` those of the float32 kernel.
* ``block_plan`` chooses the bf16 kernel's grid without a bias: how many
  256-row blocks each (image, head) takes before 128-row blocks cover the
  rest of its rows, so that small grids fill the card's SMs.

A launch's host cost is kept small where the layout is the common one:
``attention_qkv`` checks the packed ``qkv`` once (not four [B, H, N, 64]
views), the bf16 entry allocates no workspace, the arguments go to the C
entry as one packed struct (``ARGS``), and the entry makes the device
current only when it is not, sets its shared-memory attribute once per
device and reuses the tensor maps of operands it has seen (per thread).
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import struct
import threading
import types

import torch

from depthg_tpu_torch.ops import _build
from depthg_tpu_torch.utils.profiling import attention_flops, counted

HEAD_DIM = 64
# the C entry's LaunchArgs: q, k, v, o, bias, workspace and stream pointers;
# the (batch, head, token) element strides of q, k, v and o, the bias's head
# and row strides; bias_kind, batch, heads, n, n_valid, is_bf16, device,
# big_blocks; the scale; padding to the struct's 8-byte alignment
ARGS = struct.Struct("<7Q14q8if4x")
# The bf16 kernel's blocks, by (rounds of 64-row sub-tiles per warpgroup,
# warpgroups that walk): their time for one walk of the keys, relative to a
# 256-row block with both rounds and both warpgroups walking. (1, 2): B=1,
# N=1536, 6 heads in one wave, 0.0178 ms in 128-row blocks against 0.0301 in
# 256-row ones (NVIDIA H100 80GB HBM3, 700.00 W; attention_contract_study.py
# --sections plans). (1, 1): that times the ratio of one warpgroup alone on
# BEiT-L's one-row blocks, with the bias (0.0130 against 0.0188 ms; the
# header of csrc/attention.cu).
BLOCK_COST = {(2, 2): 1.0, (1, 2): 0.59, (1, 1): 0.40}
BLOCK_ROWS = 256  # rows of a block with two rounds; the others hold 128
# block_plan leaves the grid of 256-row blocks only for a finish the model
# puts at least this much earlier: against the card it was up to 5% too
# hopeful about moving the short last blocks to the grid's end (train
# B=32, N=785: 0.963 predicted, 1.008 measured; attention_contract_study.py
# --sections plans, NVIDIA H100 80GB HBM3, 700.00 W)
PLAN_MARGIN = 0.9


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
        """The entries of ``csrc/attention.cu``: ``fwd`` (takes ``ARGS``
        packed) and ``workspace_bytes``."""
        with self._lock:
            if self._fns is None:
                lib = _build.load("attention")
                size = lib.depthg_attention_args_bytes()
                if size != ARGS.size:
                    raise RuntimeError(f"attention kernel: its C entry takes {size} bytes of "
                                       f"arguments, the wrapper packs {ARGS.size}")
                fwd = lib.depthg_attention_launch
                fwd.argtypes = [ctypes.c_char_p]
                fwd.restype = ctypes.c_int
                ws = lib.depthg_attention_workspace_bytes
                ws.argtypes = [ctypes.c_int] * 4
                ws.restype = ctypes.c_longlong
                self._fns = types.SimpleNamespace(fwd=fwd, workspace_bytes=ws)
            return self._fns


KERNEL = _AttentionKernel()


def plan_blocks(batch: int, heads: int, n: int, big: int) -> list:
    """The bf16 grid's blocks in launch order, as (first row, rows): ``big``
    blocks of 256 rows per (image, head) over rows [0, 256 big), then blocks
    of 128 rows over [256 big, n) (``csrc/attention.cu`` ``bf16_block``);
    within each part the row blocks of one image, then the images of one
    head, then the heads."""
    small = max(0, -(-(n - BLOCK_ROWS * big) // (BLOCK_ROWS // 2)))
    part = [(BLOCK_ROWS * i, BLOCK_ROWS) for i in range(big)]
    part2 = [(BLOCK_ROWS * big + BLOCK_ROWS // 2 * i, BLOCK_ROWS // 2) for i in range(small)]
    return part * (batch * heads) + part2 * (batch * heads)


def block_cost(q0: int, rows: int, n_valid: int) -> float:
    """``BLOCK_COST`` of the block at rows [q0, q0 + rows): its second round
    is walked only where it holds a row < n_valid, its second warpgroup only
    where rows past its first 64 do."""
    rounds = 2 if rows == BLOCK_ROWS and q0 + BLOCK_ROWS // 2 < n_valid else 1
    return BLOCK_COST[(rounds, 1 if q0 + 64 >= n_valid else 2)]


@functools.lru_cache(maxsize=512)
def block_plan(batch: int, heads: int, n: int, n_valid: int, sms: int = 132) -> int:
    """256-row blocks per (image, head) of the bias-free bf16 kernel's grid.

    The card runs one block per SM and hands the blocks out in launch
    order, so each choice from ceil(n / 256) (every block 256 rows) down
    to 0 (every block 128 rows) is
    dispatched on ``sms`` SMs as the card does, with ``block_cost`` as each
    block's time (``plan_finish``). The one that finishes first is taken
    (the more 256-row blocks on a tie) if it finishes ``PLAN_MARGIN`` of
    the all-256-row grid's time or sooner; else that grid. Fewer than ~1.5
    waves of 256-row blocks leave SMs idle, and 128-row blocks fill them; at
    several waves the 256-row blocks, which stream each head's keys once per
    256 rows, win. Every row walks the same key tiles in the same order
    whatever the choice: the bits are the same."""
    top = -(-n // BLOCK_ROWS)
    best, best_end = top, plan_finish(batch, heads, n, n_valid, top, sms)
    everything = best_end
    for big in range(top - 1, -1, -1):
        end = plan_finish(batch, heads, n, n_valid, big, sms)
        if end < best_end - 1e-9:
            best, best_end = big, end
    return best if best_end <= PLAN_MARGIN * everything else top


def plan_finish(batch: int, heads: int, n: int, n_valid: int, big: int, sms: int) -> float:
    """When the last of ``plan_blocks(..., big)`` ends, in 256-row block
    times, each block handed to the first SM that is free."""
    free = [0.0] * sms
    for q0, rows in plan_blocks(batch, heads, n, big):
        heapq.heappush(free, heapq.heappop(free) + block_cost(q0, rows, n_valid))
    return max(free)


_SMS: dict = {}


def _sms(device: int) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


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


def _check_args(shape, dtypes, device, n_valid, bias):
    """The checks of ``_check`` on q's [B, H, N, HD] shape, the three
    operands' dtypes and q's device."""
    if shape[-1] != HEAD_DIM:
        raise ValueError(f"attention kernel supports head_dim {HEAD_DIM}, "
                         f"got {shape[-1]}")
    if not (dtypes[0] == dtypes[1] == dtypes[2]) or dtypes[0] not in (torch.float32,
                                                                     torch.bfloat16):
        raise ValueError(f"attention needs float32 or bfloat16 q/k/v of one "
                         f"dtype, got {dtypes[0]}, {dtypes[1]}, {dtypes[2]}")
    n = shape[2]
    nv = n if n_valid is None else int(n_valid)
    if not 1 <= nv <= n:
        raise ValueError(f"n_valid must be in [1, {n}], got {nv}")
    if bias is not None:
        h = shape[1]
        if tuple(bias.shape) != (h, n, n):
            raise ValueError(f"bias must be [{h}, {n}, {n}], got {tuple(bias.shape)}")
        if bias.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"bias must be float32 or bfloat16, got {bias.dtype}")
        if bias.device != device:
            raise ValueError(f"bias on {bias.device}, q on {device}")
    return nv


def _check(q, k, v, n_valid, bias=None):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention needs q/k/v of one [B, H, N, {HEAD_DIM}] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    return _check_args(q.shape, (q.dtype, k.dtype, v.dtype), q.device, n_valid, bias)


def _check_operand(name, ptr, strides, itemsize):
    """Raises unless the kernel can read a [B, H, N, 64] operand at ``ptr``
    with element ``strides``."""
    sb, sh, sn, sd = strides
    if sd != 1:
        raise ValueError(f"attention kernel needs a contiguous head_dim; "
                         f"{name} has strides {strides}")
    # the bf16 kernel reads q, k and v through TMA tensor maps: a 16-byte
    # aligned base and strides that are positive multiples of 16 bytes
    if ptr % 16 or sb * itemsize % 16 or sh * itemsize % 16 or sn * itemsize % 16:
        raise ValueError(f"attention kernel needs 16-byte aligned rows; "
                         f"{name} has strides {strides}")
    if sb <= 0 or sh <= 0 or sn <= 0:
        raise ValueError(f"attention kernel needs positive strides; "
                         f"{name} has strides {strides}")


def _check_launch(requires_grad: bool, bias):
    """The launch's own refusals: a gradient it cannot give, a bias it
    cannot read."""
    if torch.is_grad_enabled() and (requires_grad or (bias is not None
                                                      and bias.requires_grad)):
        raise RuntimeError("attention kernel has no backward (as in the JAX package), so "
                           "a gradient through it would be lost: run the eager path "
                           "(attn_impl=\"xla\") with gradients on, or call it under "
                           "torch.no_grad()")
    if bias is not None and (bias.stride(-1) != 1 or bias.stride(1) <= 0 or bias.stride(1) % 8
                             or bias.stride(0) <= 0 or bias.stride(0) % 8
                             or bias.data_ptr() % 16):
        # read through a TMA tensor map straight from the caller's view
        raise ValueError(f"attention kernel needs a bias with a contiguous last "
                         f"axis, head and row strides that are positive multiples "
                         f"of 8 and a 16-byte aligned base; got strides "
                         f"{bias.stride()}, base {bias.data_ptr() % 16} bytes "
                         f"past 16")


def _launch(q, k, v, out, scale: float, nv: int, bias=None):
    """Launch the kernel on [B, H, N, 64] views (``out`` may be a view) with
    an optional [H, N, N] bias view."""
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel needs CUDA tensors, got {q.device}")
    _check_launch(q.requires_grad or k.requires_grad or v.requires_grad, bias)
    itemsize = q.element_size()
    ops = []
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        ptr, strides = t.data_ptr(), t.stride()
        _check_operand(name, ptr, strides, itemsize)
        ops.append((ptr, strides[:3]))
    return _fire(ops, q.shape, q.dtype, out, scale, nv, bias)


def _fire(ops, shape, dtype, out, scale, nv, bias):
    """The launch itself, after the checks: ``ops`` holds (data pointer,
    (batch, head, token) element strides) of q, k, v and out; ``shape`` is
    q's [B, H, N, 64]. The bf16 grid is ``block_plan``'s without a bias,
    every block 256 rows with one."""
    b, h, n, _ = shape
    if n >= 2 ** 31 // 2:
        raise ValueError(f"sequence too long for the kernel: {n}")
    fns = KERNEL._fns or KERNEL.fn()
    bf16 = dtype == torch.bfloat16
    device = out.get_device()
    ws, ws_ptr = None, 0
    if not bf16:
        # the float32 kernel's split k and v (their layout is the kernel's
        # own); freed on return, the memory is reused only by work queued
        # after the kernel on this stream
        ws = torch.empty(fns.workspace_bytes(b, h, nv, 0), dtype=torch.uint8, device=out.device)
        ws_ptr = ws.data_ptr()
    big_blocks = (block_plan(b, h, n, nv, _sms(device)) if bf16 and bias is None
                  else -(-n // BLOCK_ROWS))
    bias_args = (0, 0, 0, 0) if bias is None else (
        bias.data_ptr(), bias.stride(0), bias.stride(1), 1 if bias.dtype == torch.bfloat16 else 2)
    (qp, qs), (kp, ks), (vp, vs), (op, os_) = ops
    err = fns.fwd(ARGS.pack(qp, kp, vp, op, bias_args[0], ws_ptr,
                            torch._C._cuda_getCurrentRawStream(device), *qs, *ks, *vs, *os_,
                            *bias_args[1:], b, h, n, nv, int(bf16), device, big_blocks, scale))
    if err == 10000:
        raise RuntimeError("attention kernel: libcuda.so.1 has no "
                           "cuTensorMapEncodeTiled (or could not be loaded)")
    if err > 10000:
        raise RuntimeError(f"attention kernel: libcuda refused a tensor map for "
                           f"shape {tuple(shape)} (CUresult {err - 10000})")
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


def _qkv_flops(qkv, num_heads, scale, n_valid=None, bias=None):
    b, n, d3 = qkv.shape
    return attention_flops(b, num_heads, n, n if n_valid is None else int(n_valid),
                           d3 // (3 * num_heads))


@counted(_qkv_flops)
def attention_qkv(qkv: torch.Tensor, num_heads: int, scale: float,
                  n_valid: int | None = None,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """Packed qkv [B, N, 3D] (K1 ``whole_kv_mha_qkv``) -> token-major [B, N, D],
    with an optional [H, N, N] logit bias.

    The kernel reads each head straight out of ``qkv`` through strides and
    writes its [N, 64] slice of the [B, N, D] output in place. On CUDA the
    checks run on ``qkv`` itself: q, k and v are its views [B, H, N, 64]
    with strides (qkv.stride(0), 64 s, qkv.stride(1), s), s = qkv.stride(2),
    at offsets of 0, D and 2 D elements, so they pass or fail together."""
    if qkv.dim() != 3:
        raise ValueError(f"attention_qkv needs [B, N, 3D], got {tuple(qkv.shape)}")
    b, n, d3 = qkv.shape
    if qkv.device.type == "cpu":
        q, k, v = split_qkv(qkv, num_heads)
        nv = _check(q, k, v, n_valid, bias)
        out = attention_plain(q, k, v, scale, nv, bias)
        return out.permute(0, 2, 1, 3).reshape(b, n, d3 // 3)
    if d3 % (3 * num_heads):
        raise ValueError(f"qkv last axis {d3} does not factor as 3 x "
                         f"{num_heads} heads")
    hd, dt = d3 // (3 * num_heads), qkv.dtype
    nv = _check_args((b, num_heads, n, hd), (dt, dt, dt), qkv.device, n_valid, bias)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention kernel needs CUDA tensors, got {qkv.device}")
    _check_launch(qkv.requires_grad, bias)
    (ptr, strides), k, v = qkv_operands(qkv, num_heads)
    _check_operand("q", ptr, strides, qkv.element_size())
    out = torch.empty((b, n, d3 // 3), dtype=dt, device=qkv.device)
    return _fire([(ptr, strides[:3]), k, v, (out.data_ptr(), (n * d3 // 3, hd, d3 // 3))],
                 (b, num_heads, n, hd), dt, out, scale, nv, bias)


def qkv_operands(qkv: torch.Tensor, num_heads: int):
    """(data pointer, element strides) of the q, k and v views that
    ``split_qkv`` makes of a packed [B, N, 3D] ``qkv``, without making them:
    q's four strides (batch, head, token, dim), k's and v's first three.
    They differ only in their base, D and 2 D elements on, so the kernel
    can read one iff it can read all three."""
    b, n, d3 = qkv.shape
    sb, sn, sd = qkv.stride()
    strides = (sb, d3 // (3 * num_heads) * sd, sn, sd)
    ptr, step = qkv.data_ptr(), d3 // 3 * sd * qkv.element_size()
    return (ptr, strides), (ptr + step, strides[:3]), (ptr + 2 * step, strides[:3])
