"""Online serving for trained segmenters: dynamic batching over the predict
step (``depthg_tpu/serve.py`` and ``scripts/serve.py``).

    python -m depthg_tpu_torch.serve model_path=./checkpoints/run.ckpt port=8080
    curl -s -X POST --data-binary @img.jpg \\
        'localhost:8080/v1/segment?format=png&probe=cluster' > labels.png

* ``DynamicBatcher``: requests arriving from any number of frontend threads
  coalesce into pow2-bucketed batches: the dispatcher waits up to
  ``max_wait_ms`` after the first request, pads the collected batch up to
  the nearest bucket and slices the real rows back out. One dispatcher
  thread owns all device work, which is strictly serialized no matter how
  many HTTP threads run. Pure Python threading, carried over unchanged.
* ``SegmentationService``: bytes -> PIL decode -> the eval center-crop
  transform (both on the calling thread) -> ``inference.make_predict_step``
  (backbone + flip-TTA + probes + dense CRF) on the dispatcher thread ->
  int label maps. The model lives on the device; each bucket has one pinned
  host buffer that batches are staged through with a non-blocking copy.
  The step runs eagerly (nothing is compiled per bucket); the buckets keep
  the set of batch shapes small and are what ``warmup()`` runs once.
  ``devices=[d0, d1, ...]`` (``build_service``'s ``n_devices``) keeps one
  replica per device, as the JAX service shards a batch over its mesh: the
  buckets are multiples of the device count, each padded batch is split
  evenly across the replicas, and each replica runs its part on its own
  thread and CUDA stream, so their launches overlap.
* ``serve_http``: a stdlib ``ThreadingHTTPServer`` frontend:
  ``POST /v1/segment`` (image bytes in, npz/png/json out), ``GET /healthz``,
  ``GET /metrics`` (request/batch counters, occupancy, latency quantiles).

Contract: a served row equals ``make_predict_step`` on the same padded
batch (rows past the real ones are copies of row 0) exactly; with several
replicas, on its replica's part of that batch. A GEMM may pick another
algorithm at another batch size, so the same image served in another
bucket may differ at a few pixels (``chip_smoke.py`` measures the
agreement across buckets).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Queue

import numpy as np
import torch

__all__ = ["BatcherMetrics", "DynamicBatcher", "SegmentationService",
           "build_service", "serve_http"]


def _bucket(n: int, max_batch: int, min_bucket: int = 1) -> int:
    """Smallest ``min_bucket * 2^k`` >= n, capped at max_batch."""
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, max_batch)


def bucket_set(max_batch: int, min_bucket: int = 1) -> list[int]:
    """Every bucket ``_bucket`` can return — the exact warmup set."""
    buckets, b = [], min_bucket
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return buckets


@dataclasses.dataclass
class _Pending:
    payload: object
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: object = None
    error: BaseException | None = None
    t_enqueue: float = dataclasses.field(default_factory=time.monotonic)
    abandoned: bool = False  # submitter timed out; don't spend device time


class BatcherMetrics:
    """Thread-safe serving counters. ``snapshot()`` is what /metrics returns."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._latencies_ms: deque[float] = deque(maxlen=window)
        self.requests = 0
        self.batches = 0
        self.batched_requests = 0  # sum of real rows over all batches
        self.padded_rows = 0
        self.errors = 0

    def record_batch(self, n_real: int, n_padded: int) -> None:
        with self._lock:
            self.batches += 1
            self.batched_requests += n_real
            self.padded_rows += n_padded - n_real

    def record_request(self, latency_ms: float, ok: bool) -> None:
        with self._lock:
            self.requests += 1
            if ok:
                self._latencies_ms.append(latency_ms)
            else:
                self.errors += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies_ms)
            q = (lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]
                 if lat else None)
            batches = max(self.batches, 1)
            return {
                "requests": self.requests,
                "errors": self.errors,
                "batches": self.batches,
                "mean_batch_occupancy": self.batched_requests / batches,
                "pad_fraction": self.padded_rows
                / max(self.batched_requests + self.padded_rows, 1),
                "latency_ms_p50": q(0.50),
                "latency_ms_p99": q(0.99),
            }


class DynamicBatcher:
    """Coalesce concurrent ``submit()`` calls into bucketed device batches.

    ``run_batch(stacked_payloads: list) -> sequence of per-item results`` is
    called from the single dispatcher thread only. The dispatcher collects up
    to ``max_batch`` items, waiting at most ``max_wait_ms`` after the FIRST
    queued item — a lone request never waits longer than that, and a full
    batch dispatches immediately.
    """

    def __init__(self, run_batch, max_batch: int = 16,
                 max_wait_ms: float = 10.0,
                 metrics: BatcherMetrics | None = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.metrics = metrics or BatcherMetrics()
        self._queue: Queue[_Pending | None] = Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="batcher", daemon=True)
        self._thread.start()

    def submit(self, payload, timeout: float | None = 120.0):
        """Block until the batch containing ``payload`` has run; returns the
        per-item result or re-raises the batch's error."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        item = _Pending(payload)
        self._queue.put(item)
        if not item.event.wait(timeout):
            item.abandoned = True  # dispatcher drops it instead of running it
            self.metrics.record_request(
                (time.monotonic() - item.t_enqueue) * 1e3, ok=False)
            raise TimeoutError("batch dispatch timed out")
        ok = item.error is None
        self.metrics.record_request(
            (time.monotonic() - item.t_enqueue) * 1e3, ok)
        if not ok:
            raise item.error
        return item.result

    def close(self, timeout: float = 10.0) -> None:
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout)
        # a submit() racing close() may have enqueued behind the sentinel;
        # fail those fast instead of letting them wait out their timeout
        while True:
            try:
                item = self._queue.get_nowait()
            except Empty:
                return
            if item is not None:
                item.error = RuntimeError("batcher is closed")
                item.event.set()

    def _collect(self) -> list[_Pending] | None:
        """One batch: block for the first item, then drain until full or the
        wait budget (measured from the first item's arrival) runs out."""
        try:
            first = self._queue.get(timeout=0.25)
        except Empty:
            return []
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remain = deadline - time.monotonic()
            try:
                item = (self._queue.get_nowait() if remain <= 0
                        else self._queue.get(timeout=remain))
            except Empty:
                break
            if item is None:  # close(): keep the sentinel semantics
                self._queue.put(None)
                break
            batch.append(item)
        return batch

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            batch = [it for it in batch if not it.abandoned]
            if not batch:
                if self._closed:
                    return
                continue
            try:
                results = self._run_batch([it.payload for it in batch])
                for it, res in zip(batch, results):
                    it.result = res
            except BaseException as e:  # noqa: BLE001 — forwarded per item
                for it in batch:
                    it.error = e
            finally:
                for it in batch:
                    it.event.set()


class SegmentationService:
    """Image bytes -> (linear, cluster) label maps through the predict step.

    Owns the model on ``device`` (or one replica on each of ``devices``)
    and the predict step; all device work funnels through one
    ``DynamicBatcher``. On a CUDA device the constructor builds both
    kernels, so no request ever waits for the compiler; ``warmup()`` runs
    every bucket once so the first real request meets warm allocator pools
    and loaded libraries.
    """

    def __init__(self, model, ecfg, res: int, max_batch: int = 16,
                 max_wait_ms: float = 10.0, device: str | torch.device = "cuda",
                 devices=None):
        from depthg_tpu_torch.data import get_transform
        from depthg_tpu_torch.inference import make_predict_step
        from depthg_tpu_torch.parallel import mesh
        from depthg_tpu_torch.runtime import get_device

        self.devices = [get_device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        # every bucket must split evenly: _bucket emits min_bucket * 2^k
        # capped at max_batch, so max_batch must be a multiple of the count
        self._min_bucket = len(self.devices)
        if max_batch % self._min_bucket:
            raise ValueError(f"max_batch={max_batch} must be a multiple of the "
                             f"{self._min_bucket} devices so every batch bucket "
                             "splits evenly")
        self.res = int(res)
        self.ecfg = ecfg
        self._transform = get_transform(self.res, False, "center")
        self._predict = make_predict_step(ecfg)
        self._models = mesh.replicate(model, self.devices)
        self._model = self._models[0]
        # replicas launch on streams of their own (one replica: the current)
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" and len(self.devices) > 1
                         else None for d in self.devices]
        self._pool = (ThreadPoolExecutor(len(self.devices), "replica")
                      if len(self.devices) > 1 else None)
        self._staging: dict[tuple, torch.Tensor] = {}  # (replica, rows) -> host buffer
        if self.device.type == "cuda":
            from depthg_tpu_torch.ops import _build, attention, crf_bilateral

            _build.build(["attention", "crf_bilateral"])
            attention.KERNEL.fn()
            crf_bilateral.KERNEL.fn()
        self.batcher = DynamicBatcher(self._run_batch, max_batch=max_batch,
                                      max_wait_ms=max_wait_ms)
        self.started = time.time()

    # -- device path ------------------------------------------------------
    def _stage(self, rows: list[np.ndarray], i: int) -> torch.Tensor:
        """Replica ``i``'s rows through its host buffer of that size (pinned
        on CUDA, so the copy to the device does not block). The buffer is
        reused: the caller fetches its results before it stages the next
        batch."""
        dev = self.devices[i]
        buf = self._staging.get((i, len(rows)))
        if buf is None:
            buf = torch.empty((len(rows), 3, self.res, self.res), dtype=torch.float32,
                              pin_memory=dev.type == "cuda")
            self._staging[(i, len(rows))] = buf
        host = buf.numpy()
        for j, img in enumerate(rows):
            host[j] = img
        return buf.to(dev, non_blocking=True)

    def _predict_part(self, rows: list[np.ndarray], i: int):
        """Replica ``i`` on its rows, on its device and stream."""
        # the dispatcher thread did not build the model: name the device here
        dev = self.devices[i]
        on = (torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext())
        stream = (torch.cuda.stream(self._streams[i]) if self._streams[i] is not None
                  else contextlib.nullcontext())
        with on, stream:
            linear, cluster = self._predict(self._models[i], self._stage(rows, i))
            return linear.cpu().numpy(), cluster.cpu().numpy()

    def _predict_padded(self, imgs: list[np.ndarray], b: int):
        """(linear, cluster) numpy label maps [b, res, res] of ``imgs``
        padded to ``b`` rows with copies of row 0; with several replicas each
        runs its contiguous ``b / n`` rows."""
        rows = list(imgs) + [imgs[0]] * (b - len(imgs))
        if self._pool is None:
            return self._predict_part(rows, 0)
        per = b // len(self.devices)
        parts = list(self._pool.map(self._predict_part,
                                    [rows[i * per:(i + 1) * per] for i in range(len(self.devices))],
                                    range(len(self.devices))))
        return tuple(np.concatenate([p[k] for p in parts]) for k in range(2))

    def _run_batch(self, imgs: list[np.ndarray]):
        n = len(imgs)
        b = _bucket(n, self.batcher.max_batch, self._min_bucket)
        self.batcher.metrics.record_batch(n, b)
        linear, cluster = self._predict_padded(imgs, b)
        return [(linear[i], cluster[i]) for i in range(n)]

    def warmup(self, buckets: tuple[int, ...] | None = None) -> list[int]:
        """Run the predict step at each reachable batch bucket (the exact
        set ``_run_batch`` can dispatch); returns them."""
        if buckets is None:
            buckets = bucket_set(self.batcher.max_batch, self._min_bucket)
        dummy = np.zeros((3, self.res, self.res), np.float32)
        for b in buckets:
            self._predict_padded([dummy], b)
        return list(buckets)

    # -- request path ------------------------------------------------------
    def segment_bytes(self, body: bytes):
        """Decode + transform on the CALLING thread (scales across HTTP
        threads), then ride one batched device dispatch."""
        from PIL import Image

        img = Image.open(io.BytesIO(body)).convert("RGB")
        arr = np.asarray(self._transform(img), np.float32)
        return self.batcher.submit(arr)

    def close(self) -> None:
        self.batcher.close()
        if self._pool is not None:
            self._pool.shutdown()


# -- HTTP frontend ---------------------------------------------------------

def _encode_response(linear: np.ndarray, cluster: np.ndarray, fmt: str,
                     probe: str):
    """-> (content_type, payload bytes). ``png`` returns ONE probe's label map
    as an 8-bit palette-free grayscale PNG; npz/json carry both."""
    if fmt == "npz":
        buf = io.BytesIO()
        np.savez_compressed(buf, linear=linear.astype(np.int32),
                            cluster=cluster.astype(np.int32))
        return "application/octet-stream", buf.getvalue()
    if fmt == "json":
        return "application/json", json.dumps(
            {"linear": linear.tolist(), "cluster": cluster.tolist()}
        ).encode()
    if probe not in ("linear", "cluster"):
        raise ValueError(f"unknown probe {probe!r} (linear|cluster)")
    if fmt == "png":
        from PIL import Image

        chosen = linear if probe == "linear" else cluster
        if chosen.max(initial=0) > 255:
            raise ValueError("png output needs <=256 classes; use npz")
        buf = io.BytesIO()
        Image.fromarray(chosen.astype(np.uint8), mode="L").save(buf, "PNG")
        return "image/png", buf.getvalue()
    raise ValueError(f"unknown format {fmt!r} (npz|json|png)")


def serve_http(service: SegmentationService, host: str = "127.0.0.1",
               port: int = 8080, start: bool = True):
    """Build (and by default start, in a daemon thread) the HTTP server.

    Returns the ``ThreadingHTTPServer``; callers own ``shutdown()``. The
    bound port is ``server.server_address[1]`` (pass port=0 for ephemeral).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1: answers curl's Expect: 100-continue instead of letting it
        # stall ~1s before sending the body; Content-Length is always set so
        # keep-alive connections stay in sync (bodies are drained below).
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet: metrics replace access logs
            pass

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict):
            self._send(code, "application/json", json.dumps(obj).encode())

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send_json(200, {"status": "ok",
                                      "uptime_s": time.time() - service.started})
            elif path == "/metrics":
                self._send_json(200, service.batcher.metrics.snapshot())
            else:
                self._send_json(404, {"error": f"no route {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            # drain the body FIRST: under keep-alive an unread body would
            # desync the next request on the connection
            length = int(self.headers.get("Content-Length", "0") or 0)
            body = self.rfile.read(length) if length > 0 else b""
            if url.path != "/v1/segment":
                self._send_json(404, {"error": f"no route {url.path}"})
                return
            q = parse_qs(url.query)
            fmt = q.get("format", ["npz"])[0]
            probe = q.get("probe", ["cluster"])[0]
            try:
                if not body:
                    raise ValueError("empty body: POST the image bytes")
                linear, cluster = service.segment_bytes(body)
                ctype, payload = _encode_response(linear, cluster, fmt, probe)
            except (ValueError, OSError) as e:  # bad image / bad params
                self._send_json(400, {"error": str(e)})
                return
            except TimeoutError as e:  # device backlogged: retryable
                self._send_json(503, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — server-side failure
                self._send_json(500, {"error": str(e)})
                return
            self._send(200, ctype, payload)

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    if start:
        threading.Thread(target=server.serve_forever, name="http",
                         daemon=True).start()
    return server


# -- the CLI ----------------------------------------------------------------

def build_service(cfg, device: str | torch.device = "cuda") -> SegmentationService:
    """Config (``serve_config.yml`` keys) -> ``SegmentationService`` with the
    checkpoint of ``cfg.model_path`` on ``device``; ``n_devices`` above 1
    keeps one replica on each of the first ``n_devices`` CUDA devices (n
    copies of the CPU for ``device="cpu"``)."""
    from depthg_tpu_torch.inference import (Segmenter, ecfg_from_checkpoint,
                                            fcfg_from_run_cfg)
    from depthg_tpu_torch.parallel import mesh
    from depthg_tpu_torch.utils.checkpoint_io import load_segmenter

    n = int(cfg.get("n_devices") or 1)
    devices = mesh.make_devices(n, torch.device(device).type) if n > 1 else None
    sd, run_cfg = load_segmenter(cfg.model_path)
    fcfg = fcfg_from_run_cfg(run_cfg)
    ecfg = ecfg_from_checkpoint(cfg, sd, run_cfg)
    return SegmentationService(
        Segmenter.from_state_dict(sd, fcfg), ecfg, res=int(cfg.res),
        max_batch=int(cfg.max_batch), max_wait_ms=float(cfg.max_wait_ms),
        device=device, devices=devices)


def main(argv=None):
    from depthg_tpu_torch.config import cli_overrides, load_config

    overrides = cli_overrides(argv if argv is not None else sys.argv[1:])
    cfg = load_config("serve_config.yml", overrides)

    service = build_service(cfg, cfg.get("device", "cuda"))
    if bool(cfg.get("warmup", True)):
        t0 = time.time()
        buckets = service.warmup()
        print(f"warmed buckets {buckets} in {time.time() - t0:.1f}s")

    server = serve_http(service, host=str(cfg.host), port=int(cfg.port),
                        start=False)
    print(f"serving on http://{cfg.host}:{server.server_address[1]} "
          f"(max_batch={cfg.max_batch}, wait={cfg.max_wait_ms}ms)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.close()


if __name__ == "__main__":
    main()
