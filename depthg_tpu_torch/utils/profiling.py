"""Profiling / observability helpers of the port (``depthg_tpu/utils/profiling.py``).

* ``StepTimer`` — rolling per-step wall-time + images/sec, host-side, zero
  device sync (a copy of the JAX package's).
* ``trace`` — context manager around ``torch.profiler`` writing a Chrome
  trace of the enclosed block into ``log_dir``.
* ``log_jsonl`` — append structured metrics to a jsonl run log (a copy).
* ``median_time`` — median host-clock seconds of a call that ends in a
  synchronize or a host fetch.
* ``dispatch_rtt`` — the round trip of one trivial kernel and its fetch.
* ``step_flops`` — the operations of one call, counted from shapes, the
  same on the CPU and on the card: PyTorch's ``FlopCounterMode`` for the
  ordinary tensor ops, and for the three functions whose work it cannot see
  or would see in another form (the attention kernel, the CRF bilateral
  message and degree, the int8 products: ``torch._int_mm`` counts 0, a
  ctypes kernel is invisible, and on the CPU their plain versions run other
  products), their own count once from their shapes (``counted``).

The formulas (``attention_flops``, ``bilateral_*_flops``,
``int8_matmul_flops``) are each function's least work; ``chip_smoke.py``'s
bounds import them.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from collections import deque

import torch


class StepTimer:
    def __init__(self, window: int = 50):
        self.times: deque = deque(maxlen=window)
        self.last = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self.last is not None:
            dt = now - self.last
            self.times.append(dt)
        self.last = now
        return dt

    @property
    def steps_per_sec(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    def images_per_sec(self, batch_size: int) -> float:
        return self.steps_per_sec * batch_size


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True, device: str | torch.device = "cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed block and write it
    as a Chrome trace (``trace_<ns>.json``) into ``log_dir``: host and CUDA
    activity, host activity only when the caller passed ``device="cpu"``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def log_jsonl(path: str, record: dict):
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


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
