"""Profiling / observability helpers of the port (``depthg_tpu/utils/profiling.py``).

* ``span`` / ``recording`` / ``collect`` / ``clear`` — the port's spans:
  named ranges at its layer boundaries (``eval.step``, ``logits``,
  ``backbone``, ``crf``, ``confusion``, ``train.step``, ``depth.step``,
  ``dpt``, ``bins``, ...), recorded while a ``torch.profiler``
  session is active or inside ``recording()``, and inert otherwise.
* ``register_counter`` — a module's own counter (a kernel's launches, say),
  which every span records as its change between the span's edges.
* ``host_sync`` — a ``host_sync`` span around a call that makes the host
  wait for the device, counted by this module's ``host_syncs`` counter.
* ``median_time`` — median host-clock seconds of a call that ends in a
  synchronize or a host fetch.
* ``dispatch_rtt`` — the round trip of one trivial kernel and its fetch.

This module imports nothing of the port: each counter is registered by the
module that owns it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Callable

import torch
import torch.autograd.profiler as _autograd_profiler

# the most spans kept between two ``clear()``s; later ones are counted as dropped
MAX_SPANS = 16384
_OFF = contextlib.nullcontext()
# the registered counters by span key; replaced whole on registration, never
# changed in place, so a span may iterate it while another thread registers
_COUNTERS: dict[str, Callable[[], int]] = {}
_REGISTER_LOCK = threading.Lock()


def register_counter(name: str, read: Callable[[], int]) -> None:
    """Record ``read()``'s change across every span as the span's ``name``
    key (a module registers its counter once, at import)."""
    global _COUNTERS
    with _REGISTER_LOCK:
        _COUNTERS = {**_COUNTERS, name: read}


class _Span:
    """One span while recording is on: host stamps on ``time.time_ns()``
    (the clock of the profiler's events), a pair of timing events on the
    current CUDA stream once CUDA is in use, and every registered counter
    read at both edges. A span opens no ``torch.profiler.record_function``:
    on the card kineto reports such a range a second time as a device event
    (a ``gpu_user_annotation``), which a trace summary that keeps every
    CUDA-typed event would count as a kernel and as busy time."""

    __slots__ = ("rec", "name", "id", "parent", "step", "t0", "t1", "counts", "events")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        self.step = self.id if self.parent is None else self.parent.step
        self.counts = {name: read() for name, read in _COUNTERS.items()}
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
        # a counter registered inside the span stood at 0 when it opened
        start = self.counts
        self.counts = {name: read() - start.get(name, 0) for name, read in _COUNTERS.items()}
        self.rec._keep(self)
        return False


class Recorder:
    """Spans kept in memory, at most ``MAX_SPANS`` between two ``clear()``s.

    Recording is on while a ``torch.profiler`` session is active or inside
    ``recording()``. Off, ``span`` returns one shared null context: no
    allocation, no ``record_function``, no CUDA event, no lock. On, each
    span records its name, its parent (the innermost open span of the same
    thread), the id of its outermost span (its step), its host start and end,
    its stream time and each registered counter's change inside it.
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
        with ``device_start_ns`` / ``device_end_ns`` on the host clock, and
        one key a registered counter (``host_syncs``; ``k1_launches``,
        ``crf_cache_launches``, ``crf_message_launches``,
        ``bins_tail_launches``, ``swiglu_gate_launches``,
        ``residual_norm_launches``, ``frozen_cache_builds``,
        ``frozen_cache_hits`` once their modules are imported); the device fields are None for a span recorded before
        CUDA was in use.
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
                   **s.counts}
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


class _Syncs:
    """The calls made through ``host_sync`` in this process."""

    def __init__(self):
        self.count = 0


SYNCS = _Syncs()
register_counter("host_syncs", lambda: SYNCS.count)


def host_sync():
    """A ``host_sync`` span around a call that makes the host wait for the
    device (a device-to-host read: ``bincount`` sizing its output from its
    input's min and max, ``.item()``, a boolean-mask index), counted once
    on ``host_syncs``. Every span open around it records the count; the
    ``host_sync`` span itself opens after it and records 0. Off: the
    shared null context and one integer add."""
    SYNCS.count += 1
    return RECORDER.span("host_sync")


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
