"""Online serving: `serve.serve_http` over a `SegmentationService` (the
`DynamicBatcher` in front of `inference.make_predict_step`) on localhost,
under open-loop arrivals from a child process (`benchmark.loadgen`).

Traffic keys: `rate` (requests/s, fixed), `sizes` ([width, height] of
the JPEGs, each an equal share of the requests), `bodies` (distinct JPEGs,
cycled), `quality`, `regions`, `unlabelled`, `max_batch`, `max_wait_ms`,
`check_requests`, `wait_s`, `trace_seconds`.

Every seed sends the same set of arrival gaps (the exponential
distribution's quantiles at `rate`, so a Poisson process's spread) and
sizes in its own order, and its own image contents.

End-to-end: `serve_p95_ms` = the 95th percentile over every request of the
window of the time from its due time to its answer; a request that fails
or never comes counts as the whole wait. `setup_s` = process start to the
first due time.

`correct`: every request is answered (`missing`, limit 0), and for
`check_requests` requests drawn from the seed the served label maps match
the plain reference's on that image alone (`label_gap`: the share of
pixels whose label differs, the worst probe and request).
"""

from __future__ import annotations

import base64
import io
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import common
from benchmark.drivers.eval import build_program
from benchmark.reference import eval as eval_ref
from benchmark.reference import serve as serve_ref
from benchmark.scenes import IMAGENET_MEAN, IMAGENET_STD, scene_batch
from benchmark.weights import make_state_dict

LIMITS = Path(__file__).resolve().parents[1] / "limits"
ROOT = Path(__file__).resolve().parents[2]


def make_bodies(cfg: dict, tr: dict, seed: int, dev) -> list:
    """JPEG bodies: scenes drawn at the largest side, cut to each size (an
    equal share of each, in the seed's order), encoded on the host."""
    from PIL import Image

    gen = torch.Generator(device=dev).manual_seed(common.stream_seed(seed, "data"))
    side = max(max(s) for s in tr["sizes"])
    n = tr["bodies"]
    sizes = [tr["sizes"][i % len(tr["sizes"])] for i in range(n)]
    random.Random(common.stream_seed(seed, "arrivals", 1)).shuffle(sizes)
    imgs = scene_batch(gen, n, side, tr["regions"], cfg["n_classes"], tr["unlabelled"])["img"]
    mean = torch.tensor(IMAGENET_MEAN, device=dev)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=dev)[None, :, None, None]
    rgb = ((imgs * std + mean).clamp(0, 1) * 255).round().to(torch.uint8)
    rgb = rgb.permute(0, 2, 3, 1).cpu().numpy()
    bodies = []
    for arr, (w, h) in zip(rgb, sizes):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(arr[:h, :w])).save(buf, "JPEG",
                                                                 quality=tr["quality"])
        bodies.append(buf.getvalue())
    return bodies


def schedule(tr: dict, seed: int, seconds: float, rate: float) -> list:
    """[[due, body]] over ``seconds``: round(rate x seconds) arrivals whose
    gaps are the exponential quantiles at ``rate`` in the seed's order."""
    n = max(1, round(rate * seconds))
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    rng = random.Random(common.stream_seed(seed, "arrivals"))
    rng.shuffle(gaps)
    due, out = 0.0, []
    for i, g in enumerate(gaps):
        out.append([due, i % tr["bodies"]])
        due += g
    return out


def start_service(cfg: dict, tr: dict, seed: int, dev):
    """(service, HTTP server, its port), warmed on every bucket."""
    from depthg_tpu_torch.serve import SegmentationService, serve_http

    from benchmark.drivers.eval import eval_config

    model, _ = build_program(cfg, seed, dev)
    service = SegmentationService(model, eval_config(cfg), res=cfg["eval"]["res"],
                                  max_batch=tr["max_batch"], max_wait_ms=tr["max_wait_ms"],
                                  device=dev)
    service.warmup()
    server = serve_http(service, host="127.0.0.1", port=0)
    return service, server, server.server_address[1]


def load(port: int, bodies: list, sched: list, keep: list, wait_s: float) -> dict:
    """Run the load generator over ``sched``; returns its result."""
    job = {"port": port, "schedule": sched, "keep": keep, "start_in": 0.5, "wait_s": wait_s,
           "bodies": [base64.b64encode(b).decode() for b in bodies]}
    proc = subprocess.Popen([sys.executable, "-m", "benchmark.loadgen"], cwd=ROOT,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        proc.stdin.write(json.dumps(job))
        proc.stdin.close()
        out = json.loads(proc.stdout.readline())
    finally:
        proc.wait(timeout=wait_s + sched[-1][0] + 120)
    return out


def trace_batches(service, dev, seconds: float, trace_seconds: float):
    """Trace the batches that start from a quarter into the window (at most
    2 s) for ``trace_seconds``, in the dispatcher thread that launches them:
    the batcher's call into the predict path is wrapped. Only the device is
    recorded: recording every host operation of the dispatcher slows its
    batches enough that the queue grows for the rest of the window. The
    profiler is started once here first, so that its start-up does not
    stall the window, and it is stopped only once the window is over: the
    returned callable stops it and gives the summary of the stretch."""
    from benchmark import trace as trace_lib

    trace_lib.Tracer(dev, host_ops=False).stop(0)  # the profiler's start-up, before the window
    batcher = service.batcher
    inner = batcher._run_batch
    start = time.perf_counter() + 0.5 + min(2.0, seconds / 4)
    state = {"tracer": None, "batches": 0, "stop": False}

    def run_batch(payloads):
        if state["tracer"] is None and time.perf_counter() >= start:
            state["tracer"] = trace_lib.Tracer(dev, host_ops=False)
        out = inner(payloads)
        tracer = state["tracer"]
        if tracer is not None and tracer.end is None:
            state["batches"] += 1
            if time.perf_counter() >= tracer.t_host + trace_seconds:
                tracer.mark_end()
        if state["stop"] and tracer is not None:
            state["stop"] = False
            tracer.stop_profiler()  # in the thread that started it, as the profiler needs
        return out

    batcher._run_batch = run_batch

    def summary():
        # one more image through the batcher, so that the dispatcher thread stops the profiler
        state["stop"] = True
        batcher.submit(np.zeros((3, service.res, service.res), np.float32))
        batcher._run_batch = inner
        return state["tracer"].summary(state["batches"])

    return summary


def latency_stats(rows: list, wait_s: float, last_due: float) -> dict:
    """Latencies from due time (failed: the whole wait), lateness of sends."""
    cap = last_due + wait_s
    lat = sorted((r[2] if r[2] is not None else cap) - r[0] for r in rows)
    late = [r[1] - r[0] for r in rows if r[1] is not None]
    q = lambda p: lat[min(len(lat) - 1, int(math.ceil(p * len(lat))) - 1)]  # noqa: E731
    return {"p50_s": q(0.50), "p95_s": q(0.95), "max_s": lat[-1],
            "late_max_s": max(late) if late else None,
            "failed": sum(r[2] is None for r in rows)}


def run(spec: dict, seed: int, seconds: float, trace: bool, dev, t_start: float) -> dict:
    cfg, tr, cell = spec["config"], spec["traffic"], spec["cell"]
    limits = json.loads((LIMITS / f"{cell['name']}.json").read_text())
    service, server, port = start_service(cfg, tr, seed, dev)
    bodies = make_bodies(cfg, tr, seed, dev)
    sched = schedule(tr, seed, seconds, tr["rate"])
    keep = common.sample_indices(seed, len(sched), tr["check_requests"])
    m = service.batcher.metrics
    before = (m.batches, m.batched_requests)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    traced = trace_batches(service, dev, seconds, tr["trace_seconds"]) if trace else None
    try:
        out = load(port, bodies, sched, keep, tr["wait_s"])
        batches, requests = m.batches - before[0], m.batched_requests - before[1]
        summary = traced() if trace else None
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    # the generator's start (the first due time) on this process's clock
    setup_s = out["t0"] - (time.monotonic() - time.perf_counter()) - t_start
    peak = common.peak_bytes(dev)
    stats = latency_stats(out["rows"], tr["wait_s"], sched[-1][0])
    print(f"serve: {len(sched)} requests at {tr['rate']} req/s, p50 "
          f"{stats['p50_s'] * 1e3:.1f} ms, max {stats['max_s'] * 1e3:.1f} ms, sends late by "
          f"at most {stats['late_max_s']} s, {batches} batches", file=sys.stderr)
    del service
    common.free(dev)
    gap = reference_gap(cfg, seed, bodies, sched, out["kept"], keep, dev)
    return {
        "metrics": {"serve_p95_ms": 1e3 * stats["p95_s"], "setup_s": setup_s},
        "attempted": len(sched), "failed": stats["failed"],
        "checks": {"missing": (stats["failed"], limits["missing"]),
                   "label_gap": (gap, limits["label_gap"])},
        "memory_peak_bytes": peak, "trace": summary,
        "counts": {"batches": batches, "batched_requests": requests},
    }


def reference_gap(cfg: dict, seed: int, bodies: list, sched: list, kept: dict, keep: list,
                  dev, quantize=None) -> float:
    """Worst share of pixels whose served label differs from the reference's
    on the image alone (1.0 for a kept request that has no answer)."""
    sd = make_state_dict(cfg, common.stream_seed(seed, "weights"), dev)
    res = cfg["eval"]["res"]
    gap = 0.0
    for i in keep:
        if str(i) not in kept:
            return 1.0
        served = np.load(io.BytesIO(base64.b64decode(kept[str(i)])))
        img = serve_ref.decode(bodies[sched[i][1]], res)[None].to(dev)
        with torch.no_grad():
            ref = eval_ref.predict(sd, cfg, img, quantize)
        for name, r in zip(("linear", "cluster"), ref):
            gap = max(gap, float((torch.from_numpy(served[name]).to(dev) != r[0]).float().mean()))
    return gap


def readings(spec: dict, seed: int, dev) -> dict:
    """`label_gap` of a short load at the cell's rate (the requests kept as
    in a run) for the program, and of the reference with an fp8 backbone
    in the program's place on the same images. A request that never comes
    reads `missing` 1 and needs no run."""
    from benchmark.reference.control import fp8_round

    cfg, tr = spec["config"], spec["traffic"]
    service, server, port = start_service(cfg, tr, seed, dev)
    bodies = make_bodies(cfg, tr, seed, dev)
    sched = schedule(tr, seed, tr["check_requests"] / tr["rate"] * 4, tr["rate"])
    keep = common.sample_indices(seed, len(sched), tr["check_requests"])
    try:
        out = load(port, bodies, sched, keep, tr["wait_s"])
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    del service
    common.free(dev)
    res = cfg["eval"]["res"]
    sd = make_state_dict(cfg, common.stream_seed(seed, "weights"), dev)
    ctrl = {}
    for i in keep:
        img = serve_ref.decode(bodies[sched[i][1]], res)[None].to(dev)
        with torch.no_grad():
            lin, clu = eval_ref.predict(sd, cfg, img, fp8_round)
        buf = io.BytesIO()
        np.savez(buf, linear=lin[0].cpu().numpy(), cluster=clu[0].cpu().numpy())
        ctrl[str(i)] = base64.b64encode(buf.getvalue()).decode()
    stats = latency_stats(out["rows"], tr["wait_s"], sched[-1][0])
    return {"program": {"label_gap": reference_gap(cfg, seed, bodies, sched, out["kept"], keep,
                                                   dev), "missing": stats["failed"]},
            "control": {"label_gap": reference_gap(cfg, seed, bodies, sched, ctrl, keep, dev)}}
