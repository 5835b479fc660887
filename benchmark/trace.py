"""The traced stretch of a `--trace 1` run: `torch.profiler` (CPU and CUDA
activities) over a few steps of the cell's own call, kept in memory and
reduced to a summary: the device's busy time (the union of its operations'
intervals), the stretch's host time, every kernel's name and duration, the
top device operations, and the longest idle gaps named by what the host
was doing.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


def _union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) nanosecond intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def _gaps(intervals, t0, t1):
    """Idle (start, end) spans of [t0, t1] outside every interval."""
    out, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return out


def _host_op_at(cpu_events, t):
    """The innermost CPU operation running at time t (ns), or ''."""
    best, best_d = "", None
    for name, s, e in cpu_events:
        if s <= t < e and (best_d is None or e - s < best_d) \
                and not name.startswith(("cuda", "cudaLaunch", "Activity Buffer")):
            best, best_d = name, e - s
    return best


class Tracer:
    """A traced stretch: ``torch.profiler`` started on construction, in the
    thread that launches the device work; ``stop(steps)`` ends it and
    returns the summary. ``host_ops=False`` records the device alone (no
    CPU operations: far less overhead in the launching thread; the idle
    gaps are then named by the next device operation only)."""

    def __init__(self, dev: torch.device, host_ops: bool = True):
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        self.dev = dev
        torch.cuda.synchronize(dev)
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
        self.prof = torch_profile(activities=acts)
        self.prof.start()
        self.t_host = time.perf_counter()
        self.t0_ns = time.time_ns()  # the profiler's timestamps are on this clock
        self.end = None

    def mark_end(self) -> None:
        """End the stretch here without stopping the profiler (whose stop
        takes long): the summary keeps the device work up to this point."""
        torch.cuda.synchronize(self.dev)
        self.end = (time.perf_counter() - self.t_host, time.time_ns())

    def stop_profiler(self) -> None:
        """Stop the profiler (from the thread that started it)."""
        if self.end is None:
            self.mark_end()
        self.prof.stop()

    def summary(self, steps: int) -> dict:
        """The stretch's summary, once the profiler has stopped."""
        window_s, t1_ns = self.end
        return summarize(self.prof, steps, window_s, (self.t0_ns, t1_ns))

    def stop(self, steps: int) -> dict:
        self.stop_profiler()
        return self.summary(steps)


def profile(step, n_steps: int, dev: torch.device) -> dict:
    """Run ``step()`` ``n_steps`` times under the profiler and summarize."""
    tracer = Tracer(dev)
    for _ in range(n_steps):
        step()
    return tracer.stop(n_steps)


def summarize(prof, n_steps: int, window_s: float, clip: tuple) -> dict:
    """The summary of the profiler's events inside ``clip`` (ns)."""
    events = prof.profiler.kineto_results.events()
    dev_ops, cpu_ops = [], []
    lo, hi = clip
    for ev in events:
        s, d = ev.start_ns(), ev.duration_ns()
        if s + d <= lo or s >= hi:
            continue
        s, d = max(s, lo), min(s + d, hi) - max(s, lo)
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev_ops.append((ev.name(), s, s + d))
        elif d > 0:
            cpu_ops.append((ev.name(), s, s + d))
    del events
    intervals = [(s, e) for _, s, e in dev_ops]
    busy_s = _union_s(intervals)
    by_name = defaultdict(float)
    for name, s, e in dev_ops:
        by_name[name] += (e - s) / 1e9
    kernels = [(name, (e - s) / 1e9) for name, s, e in dev_ops
               if not name.startswith(("Memcpy", "Memset"))]
    gaps = []
    if dev_ops:
        # the stretch on the trace's own clock: from the first host event to its last
        t0 = min([s for _, s, _ in cpu_ops] + [s for s, _ in intervals])
        t1 = max([e for _, _, e in cpu_ops] + [e for _, e in intervals])
        for gs, ge in sorted(_gaps(intervals, t0, t1), key=lambda g: g[0] - g[1])[:10]:
            nxt = min((op for op in dev_ops if op[1] >= ge), key=lambda op: op[1], default=None)
            what = _host_op_at(cpu_ops, (gs + ge) // 2) or "host"
            label = what + (" -> " + nxt[0][:80] if nxt else " -> end")
            gaps.append([label, (ge - gs) / 1e9])
    return {
        "steps": n_steps, "window_s": window_s, "busy_s": busy_s,
        "kernels": kernels, "n_kernels": len(kernels),
        "device_ops": sorted(([k[:120], v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": gaps,
    }
