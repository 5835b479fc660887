"""Profiling / observability helpers of the port (``depthg_tpu/utils/profiling.py``).

* ``span`` / ``recording`` / ``collect`` / ``clear`` — the port's spans:
  named ranges at its layer boundaries (``eval.step``, ``backbone``,
  ``crf``, ``train.step``, ``depth.step``, ``dpt``, ``bins``, ...), recorded while a ``torch.profiler``
  session is active or inside ``recording()``, and inert otherwise.
* ``median_time`` — median host-clock seconds of a call that ends in a
  synchronize or a host fetch.
* ``dispatch_rtt`` — the round trip of one trivial kernel and its fetch.
* ``step_flops`` — the operations of one call, counted from shapes, the
  same on the CPU and on the card: PyTorch's ``FlopCounterMode`` for the
  ordinary tensor ops, and for the functions whose work it cannot see or
  would see in another form (the attention kernel, the CRF bilateral
  message and degree, its int8 kernel cache, the int8 products:
  ``torch._int_mm`` counts 0, a ctypes kernel is invisible, and on the CPU
  their plain versions run other products; ZoeDepth's bins tail kernel),
  their own count once from their shapes (``counted``).

The formulas (``attention_flops``, ``bilateral_*_flops``,
``int8_matmul_flops``, ``bins_tail_flops``) are each function's least work;
``chip_smoke.py``'s bounds import them.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import sys
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler

# the most spans kept between two ``clear()``s; later ones are counted as dropped
MAX_SPANS = 16384
_OFF = contextlib.nullcontext()


def _k1_launches() -> int:
    """K1's own launch counter as it stands."""
    from depthg_tpu_torch.ops import attention

    return attention.KERNEL.launches


def _crf_cache_launches() -> int:
    """The int8 cache kernel's own launch counter as it stands."""
    from depthg_tpu_torch.ops import crf_bilateral

    return crf_bilateral.KERNEL.cache_launches


def _bins_launches() -> int:
    """The bins tail kernel's own launch counter as it stands."""
    from depthg_tpu_torch.ops import zoe_bins

    return zoe_bins.KERNEL.bins_launches


def _rel_bias_builds() -> int:
    """BEiT's relative-position biases built so far: none while its module
    has not been imported (read without importing it)."""
    beit = sys.modules.get("depthg_tpu_torch.models.zoedepth.beit")
    return 0 if beit is None else beit.BIAS_BUILDS.count


class _Span:
    """One span while recording is on: host stamps on ``time.time_ns()``
    (the clock of the profiler's events), a pair of timing events on the
    current CUDA stream once CUDA is in use, and the launch counters of K1,
    of the CRF's int8 cache kernel and of ZoeDepth's bins tail kernel and
    BEiT's count of relative-position biases built read at both edges. A
    span opens no ``torch.profiler.record_function``: on the card kineto
    reports such a range a second time as a device event (a
    ``gpu_user_annotation``), which a trace summary that keeps every
    CUDA-typed event would count as a kernel and as busy time."""

    __slots__ = ("rec", "name", "id", "parent", "step", "t0", "t1", "k1", "cache", "bins",
                 "bias", "events")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        self.step = self.id if self.parent is None else self.parent.step
        self.k1 = _k1_launches()
        self.cache = _crf_cache_launches()
        self.bins = _bins_launches()
        self.bias = _rel_bias_builds()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        self.rec._stack().pop()
        if self.events is not None:
            self.events[1].record()
        self.k1 = _k1_launches() - self.k1
        self.cache = _crf_cache_launches() - self.cache
        self.bins = _bins_launches() - self.bins
        self.bias = _rel_bias_builds() - self.bias
        self.rec._keep(self)
        return False


class Recorder:
    """Spans kept in memory, at most ``MAX_SPANS`` between two ``clear()``s.

    Recording is on while a ``torch.profiler`` session is active or inside
    ``recording()``. Off, ``span`` returns one shared null context: no
    allocation, no ``record_function``, no CUDA event, no lock. On, each
    span records its name, its parent (the innermost open span of the same
    thread), the id of its outermost span (its step), its host start and end,
    its stream time, the launches of K1, of the int8 cache kernel and of the
    bins tail kernel and the relative-position biases built inside it.
    Nothing waits for the device until ``collect()``."""

    def __init__(self):
        self._on = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._spans: list = []
        self._dropped = 0

    def span(self, name: str):
        """A context manager that records the enclosed block as ``name``."""
        if self._on or _autograd_profiler._is_profiler_enabled:
            return _Span(self, name)
        return _OFF

    @contextlib.contextmanager
    def recording(self):
        """Record spans inside the block, with or without a profiler."""
        with self._lock:
            self._on += 1
        try:
            yield self
        finally:
            with self._lock:
                self._on -= 1

    def clear(self) -> None:
        with self._lock:
            self._spans, self._dropped = [], 0

    def collect(self) -> dict:
        """``{"spans": [...], "dropped": n}``, the spans kept so far in the
        order they opened (they stay kept until ``clear()``), each a plain
        dict: ``id``, ``name``, ``parent`` (id or None), ``step`` (the
        outermost span's id), ``host_start_ns`` / ``host_end_ns``
        (``time.time_ns()``), ``host_ms``, ``self_host_ms`` (the span less
        its children), ``device_ms`` (stream time between the span's edges)
        with ``device_start_ns`` / ``device_end_ns`` on the host clock,
        ``k1_launches``, ``crf_cache_launches``, ``bins_tail_launches`` and
        ``rel_bias_builds``; the device fields are None for a span recorded
        before CUDA was in use.
        One synchronize: an
        anchor event recorded now on the current device puts the events on
        the host clock."""
        with self._lock:
            spans, dropped = sorted(self._spans, key=lambda s: s.id), self._dropped
        anchor = None
        if any(s.events is not None for s in spans):
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
            torch.cuda.synchronize()
            t_anchor = time.time_ns()
        out = []
        for s in spans:
            rec = {"id": s.id, "name": s.name,
                   "parent": None if s.parent is None else s.parent.id, "step": s.step,
                   "host_start_ns": s.t0, "host_end_ns": s.t1, "host_ms": (s.t1 - s.t0) / 1e6,
                   "device_ms": None, "device_start_ns": None, "device_end_ns": None,
                   "k1_launches": s.k1, "crf_cache_launches": s.cache,
                   "bins_tail_launches": s.bins, "rel_bias_builds": s.bias}
            if s.events is not None:
                e0, e1 = s.events
                rec["device_ms"] = e0.elapsed_time(e1)
                rec["device_start_ns"] = t_anchor - round(e0.elapsed_time(anchor) * 1e6)
                rec["device_end_ns"] = t_anchor - round(e1.elapsed_time(anchor) * 1e6)
            out.append(rec)
        children = defaultdict(float)
        for rec in out:
            children[rec["parent"]] += rec["host_ms"]
        for rec in out:
            rec["self_host_ms"] = rec["host_ms"] - children[rec["id"]]
        return {"spans": out, "dropped": dropped}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, span: _Span) -> None:
        with self._lock:
            if len(self._spans) < MAX_SPANS:
                self._spans.append(span)
            else:
                self._dropped += 1


RECORDER = Recorder()
span = RECORDER.span
recording = RECORDER.recording
collect = RECORDER.collect
clear = RECORDER.clear


def median_time(fn, repeats: int = 5) -> float:
    """Median host-clock seconds of ``fn()`` over ``repeats`` calls. ``fn``
    must end in a synchronize or a host fetch, so that the clock sees the
    device's work."""
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def dispatch_rtt(device: str | torch.device = "cuda", repeats: int = 5) -> float:
    """Median seconds of one trivial kernel launched on ``device`` and its
    result fetched to the host (``.item()``): the fixed cost of a launch and
    a fetch, recorded beside the timings (not subtracted from them: the
    bench times its chains with CUDA events)."""
    x = torch.ones((), device=device)
    (x * 2.0).item()  # first launch (lazy context, kernel load) outside the reps
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        (x * 2.0).item()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def attention_flops(b: int, h: int, n: int, n_valid: int, d: int = 64) -> float:
    """Masked attention on [B, H, N, D]: q k^T and P v over the keys that
    weigh, 2 N n_valid D operations each per (image, head)."""
    return 4.0 * b * h * n * n_valid * d


def bilateral_exponent_flops(b: int, n: int) -> float:
    """The CRF kernel's exponent -|f_i - f_j|^2 / 2 for every pair, as one
    product over the 5 features augmented to 8 (f_i . f_j - |f_i|^2 / 2 -
    |f_j|^2 / 2, the TPU kernel's form)."""
    return 2.0 * b * n * n * 8


def bilateral_cache_flops(b: int, n: int) -> float:
    """The int8 kernel cache's exponent as the eager build counts it: an
    [N, 5] x [5, N] product per image (``FlopCounterMode`` of ``a @ b.T``)."""
    return 2.0 * b * n * n * 5


def bilateral_product_flops(b: int, n: int, c: int) -> float:
    """K Z for [B, N, N] K and [B, N, C] Z."""
    return 2.0 * b * n * n * c


def bilateral_message_flops(b: int, n: int, c: int) -> float:
    """The bilateral message K Z with K never stored: the exponent and the product."""
    return bilateral_exponent_flops(b, n) + bilateral_product_flops(b, n, c)


def bilateral_degree_adds(b: int, n: int) -> float:
    """K 1: one add per entry of K."""
    return float(b) * n * n


def bilateral_degree_flops(b: int, n: int) -> float:
    """The degree K 1: the exponent and one add per entry."""
    return bilateral_exponent_flops(b, n) + bilateral_degree_adds(b, n)


def int8_matmul_flops(m: int, k: int, n: int) -> float:
    """An [M, K] x [K, N] product."""
    return 2.0 * m * k * n


def bins_tail_flops(b: int, h: int, w: int, c_in: int, bottleneck: int) -> float:
    """ZoeDepth's bins tail: the c_in -> bottleneck -> 4 products per pixel
    of [B, H, W], as the flop counter counts the two 1x1 convolutions."""
    return 2.0 * b * h * w * (c_in * bottleneck + bottleneck * 4)


# one running total per open ``step_flops`` (innermost last)
_TOTALS: list = []


def counted(work):
    """Decorator of a function whose work ``step_flops`` takes from its
    shapes: while a count is open, a call adds ``work(*args, **kwargs)``
    operations once and runs with PyTorch's dispatch modes (the flop
    counter's) switched off, so that its own tensor ops (the plain
    version's products on the CPU) are not counted a second time.
    Otherwise the call goes straight through."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _TOTALS:
                return fn(*args, **kwargs)
            from torch.utils._python_dispatch import _disable_current_modes

            _TOTALS[-1] += work(*args, **kwargs)
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return inner
    return wrap


def step_flops(fn, *args, **kwargs) -> float:
    """Operations of one call ``fn(*args, **kwargs)``: ``FlopCounterMode``'s
    total plus the shape counts of the ``counted`` functions it reached.
    The call runs once, on whatever device its inputs are on."""
    from torch.utils.flop_counter import FlopCounterMode

    _TOTALS.append(0.0)
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
    finally:
        own = _TOTALS.pop()
    return float(counter.get_total_flops()) + own
