"""ZoeDepth's metric-bins head at full resolution: Hopper kernel + its plain
version.

The tail of ``ZoeDepth._bins`` after the attractor stages, from the
decoder's ``out_conv`` features to the metric depth: the relative depth
joined to ``out_conv``, the last bin embedding and the last bin centers
resized from half resolution (bilinear, ``align_corners=True``), the
conditional log-binomial over the bins (``heads.ConditionalLogBinomial``:
161 -> 80 -> 4 with GELU and softplus, the probability and temperature
ratios, ``heads.log_binomial``) and the expectation over the centers. It
replaces no TPU kernel: the JAX package leaves these operations to XLA
(``depthg_tpu/models/zoedepth/heads.py`` and ``model.py``).

* ``bins_tail_plain``: the module's code as ``_bins`` runs it, on any
  device, dtype and widths, with or without gradients; it also returns the
  probabilities and the resized centers.
* ``bins_tail``: the kernel ``csrc/zoe_bins.cu``, one launch for the batch,
  at the released head's widths (64 bins, a 128-wide embedding, 32 + 1 +
  128 inputs, a bottleneck of 80), in bf16, without gradients, on CUDA
  tensors in the layout the decoder leaves them (channels-last maps). It
  raises on anything else: there is no fallback. It rounds where the bf16
  module rounds and keeps float32 where it does (the header of
  ``csrc/zoe_bins.cu``), so it returns the plain version's depth and
  ``feats`` up to the order of sums and one bf16 step of a resized value.
* ``takes`` says which of the two ``_bins`` runs, from the call's tensors.
* ``KERNEL.bins_launches`` counts the kernel's launches; the spans record
  it as ``bins_tail_launches``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from depthg_tpu_torch.ops import _build
from depthg_tpu_torch.ops.resize import resize_bilinear
from depthg_tpu_torch.utils import profiling

# the released head's widths, the only ones the kernel takes
OUT_CONV, EMB, N_BINS, BOTTLENECK = 32, 128, 64, 80
# the device type whose tensors the kernel takes
DEVICE_TYPE = "cuda"


class _BinsKernel:
    """The compiled library (built on first CUDA call) and its launch count."""

    def __init__(self):
        self.bins_launches = 0
        self._fn = None
        # the service's replicas launch from one thread each
        self._lock = threading.Lock()

    def count(self) -> None:
        with self._lock:
            self.bins_launches += 1

    def fn(self):
        """The C entry ``depthg_zoe_bins_tail``."""
        with self._lock:
            if self._fn is None:
                fn = _build.load("zoe_bins").depthg_zoe_bins_tail
                fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_float] * 2
                               + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn


KERNEL = _BinsKernel()
profiling.register_counter("bins_tail_launches", lambda: KERNEL.bins_launches)


def bins_tail_plain(last, rel, prev_emb, b_centers, clb):
    """(depth [B, 1, H, W], feats, probs, resized centers) from ``out_conv``
    [B, C, H, W], the resized relative depth [B, 1, H, W], the last bin
    embedding and bin centers at any size, and the head's
    ``ConditionalLogBinomial`` ``clb``."""
    last = torch.cat([last, rel], dim=1)
    emb_up = resize_bilinear(prev_emb, last.shape[-2:], align_corners=True)
    probs = clb(last, emb_up)
    centers_up = resize_bilinear(b_centers, probs.shape[-2:], align_corners=True)
    depth = torch.sum(probs * centers_up, dim=1, keepdim=True)
    return depth, emb_up, probs, centers_up


def _weights(clb):
    """(W1, b1, W2, b2) of the head's two 1x1 convolutions."""
    first, _, second, _ = clb.mlp
    return first.weight, first.bias, second.weight, second.bias


def _released_widths(last, rel, prev_emb, b_centers, n_bins, w1, w2) -> bool:
    b, c, h, w = last.shape
    return (c == OUT_CONV and n_bins == N_BINS and h % 2 == 0 and w % 2 == 0
            and w1.shape == (BOTTLENECK, OUT_CONV + 1 + EMB, 1, 1)
            and w2.shape == (4, BOTTLENECK, 1, 1) and rel.shape == (b, 1, h, w)
            and prev_emb.shape == (b, EMB, h // 2, w // 2)
            and b_centers.shape == (b, N_BINS, h // 2, w // 2))


def takes(last, rel, prev_emb, b_centers, clb) -> bool:
    """Whether ``bins_tail`` computes this call: gradients off, the maps on
    the kernel's device type, maps and weights bf16, the released head's
    widths, the embedding and centers at half the output size."""
    if torch.is_grad_enabled() or last.device.type != DEVICE_TYPE:
        return False
    w1, b1, w2, b2 = _weights(clb)
    return (all(t is not None and t.dtype == torch.bfloat16
                for t in (last, rel, prev_emb, b_centers, w1, b1, w2, b2))
            and _released_widths(last, rel, prev_emb, b_centers, clb.n_classes, w1, w2))


def _check(last, rel, prev_emb, b_centers, clb):
    """Raises ValueError on anything the kernel does not take."""
    if torch.is_grad_enabled():
        raise ValueError("the bins tail kernel has no backward: call it with gradients off")
    w1, b1, w2, b2 = _weights(clb)
    named = (("out_conv", last), ("rel", rel), ("prev_emb", prev_emb),
             ("b_centers", b_centers), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2))
    for name, t in named:
        if t is None or not t.is_cuda:
            raise ValueError(f"bins tail kernel needs CUDA tensors; {name} is on "
                             f"{None if t is None else t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"bins tail kernel needs bf16 tensors; {name} is {t.dtype}")
        if t.device != last.device:
            raise ValueError("bins tail tensors must be on one device")
        if t.data_ptr() % 16:
            raise ValueError(f"bins tail kernel needs 16-byte aligned tensors; {name} is not")
    if last.dim() != 4 or not _released_widths(last, rel, prev_emb, b_centers, clb.n_classes,
                                               w1, w2):
        raise ValueError(
            f"bins tail kernel takes the released head's widths (out_conv [B, {OUT_CONV}, H, W], "
            f"rel [B, 1, H, W], prev_emb [B, {EMB}, H/2, W/2], b_centers [B, {N_BINS}, H/2, "
            f"W/2], {N_BINS} bins, W1 [{BOTTLENECK}, {OUT_CONV + 1 + EMB}], W2 [4, "
            f"{BOTTLENECK}]), got out_conv {tuple(last.shape)}, rel {tuple(rel.shape)}, "
            f"prev_emb {tuple(prev_emb.shape)}, b_centers {tuple(b_centers.shape)}, "
            f"{clb.n_classes} bins, W1 {tuple(w1.shape)}, W2 {tuple(w2.shape)}")
    for name, t in named[:4]:
        if not t.is_contiguous(memory_format=torch.channels_last if t is not rel
                               else torch.contiguous_format):
            raise ValueError(f"bins tail kernel needs {name} contiguous (channels-last for "
                             f"the maps), got strides {t.stride()}")
    for name, t in named[4:]:
        if not t.is_contiguous():
            raise ValueError(f"bins tail kernel needs contiguous {name}, strides {t.stride()}")


def bins_tail(last, rel, prev_emb, b_centers, clb):
    """(depth [B, 1, H, W] float32, feats [B, 128, H, W] bf16 channels-last)
    of ``bins_tail_plain`` in one launch; the arguments as there, in the
    kernel's widths, dtype and layouts (``takes``), else ValueError."""
    _check(last, rel, prev_emb, b_centers, clb)
    b, _, h, w = last.shape
    if max(b, h, w) >= 2 ** 31:  # the C entry takes int; it checks the tile count
        raise ValueError(f"shape too large for the kernel: {tuple(last.shape)}")
    depth = torch.empty((b, 1, h, w), dtype=torch.float32, device=last.device)
    feats = torch.empty((b, EMB, h, w), dtype=torch.bfloat16, device=last.device,
                        memory_format=torch.channels_last)
    w1, b1, w2, b2 = _weights(clb)
    fn = KERNEL.fn()
    with torch.cuda.device(last.device):
        stream = torch.cuda.current_stream(last.device).cuda_stream
        err = fn(last.data_ptr(), rel.data_ptr(), prev_emb.data_ptr(), b_centers.data_ptr(),
                 w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 clb.max_temp - clb.min_temp, clb.min_temp, depth.data_ptr(), feats.data_ptr(),
                 b, h, w, h // 2, w // 2, stream)
    if err != 0:
        raise RuntimeError(f"bins tail kernel launch failed for {tuple(last.shape)}: "
                           f"CUDA error {err}")
    KERNEL.count()
    return depth, feats
