"""What a served batch costs on the GPU per bucket, and what the server
sustains over HTTP.

    python -m depthg_tpu_torch.profile_serve [--runs 10] [--seconds 6]
        [--out FILE] [max_batch=16] [crf_KEY=VALUE ...]

Full-width ViT-S/8 with random weights (``torch.Generator`` seed 0) behind a
``SegmentationService`` configured by ``serve_config.yml`` plus the ``k=v``
overrides (320 px, the default CRF point, bf16 backbone, stacked TTA).
Prints one JSON object (also written to ``--out``):

* ``buckets``: for each bucket of the service, the host-clock ms of one
  dispatched batch (staging, the predict step, the fetch of both label
  maps; median and all ``--runs`` readings after a warm-up), and one batch
  under ``torch.profiler``: the device's own time, the number of device
  events and the device's busy share of that batch;
* ``load``: ``serve_loadgen.run`` against the server over HTTP on
  localhost for ``--seconds`` with 1 and with 16 clients posting one
  synthetic JPEG, once with the clients as threads of this process (they
  share the interpreter lock with the server) and once as a process of
  their own: img/s, latency quantiles, batches, occupancy, pad fraction.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from depthg_tpu_torch import inference, serve, serve_loadgen
from depthg_tpu_torch.config import load_config
from depthg_tpu_torch.models import featurizer


def synthetic_jpeg(seed: int, width: int = 480, height: int = 360) -> bytes:
    """JPEG bytes of a smooth random image (an 8x coarser noise grid,
    upsampled): label maps away from ties, as a photograph's."""
    from PIL import Image

    low = (np.random.default_rng(seed).random((height // 8, width // 8, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(low).resize((width, height), Image.BILINEAR).save(buf, "JPEG", quality=92)
    return buf.getvalue()


def load_run(svc, fn) -> dict:
    """``fn()`` -> the load generator's result, with this run's own batch
    counters (the server's snapshot is cumulative)."""
    m = svc.batcher.metrics
    before = (m.batches, m.batched_requests, m.padded_rows)
    out = fn()
    batches, rows, padded = (a - b for a, b in zip(
        (m.batches, m.batched_requests, m.padded_rows), before))
    out.pop("server_metrics", None)  # cumulative since the server started
    out.update(batches=batches, mean_batch_occupancy=rows / max(batches, 1),
               pad_fraction=padded / max(rows + padded, 1))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("overrides", nargs="*", help="serve_config.yml keys, k=v")
    args = ap.parse_args(argv)

    cfg = load_config("serve_config.yml", args.overrides)
    model = inference.Segmenter(featurizer.FeaturizerConfig(), 27, 27).init_weights(
        torch.Generator().manual_seed(0))
    ecfg = inference.ecfg_from_checkpoint(cfg, model.state_dict(), {})
    svc = serve.SegmentationService(model, ecfg, res=int(cfg.res), max_batch=int(cfg.max_batch),
                                    max_wait_ms=float(cfg.max_wait_ms), device="cuda")
    from PIL import Image

    arrs = [np.asarray(svc._transform(Image.open(io.BytesIO(synthetic_jpeg(i))).convert("RGB")),
                       np.float32) for i in range(int(cfg.max_batch))]
    buckets = {}
    for b in svc.warmup():
        times = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            svc._predict_padded(arrs[:b], b)
            times.append((time.perf_counter() - t0) * 1e3)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc._predict_padded(arrs[:b], b)
            profiled_ms = (time.perf_counter() - t0) * 1e3
        on_device = [k for k in prof.key_averages() if k.self_device_time_total > 0
                     and k.device_type != torch.autograd.DeviceType.CPU]
        device_ms = sum(k.self_device_time_total for k in on_device) / 1e3
        median = statistics.median(times)
        buckets[b] = {"ms_median": median, "ms_runs": times, "ms_per_image": median / b,
                      "device_ms": device_ms, "device_events": sum(k.count for k in on_device),
                      "device_busy_share": device_ms / median, "ms_under_profiler": profiled_ms}

    server = serve.serve_http(svc, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    body = synthetic_jpeg(100)
    load = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            image = os.path.join(tmp, "image.jpg")
            with open(image, "wb") as f:
                f.write(body)
            for clients in (1, 16):
                load.append({"clients_in": "threads of the server's process", **load_run(
                    svc, lambda: serve_loadgen.run(base, body, clients, args.seconds))})
                # by file path: the load generator is stdlib only and then imports no torch
                cmd = [sys.executable, serve_loadgen.__file__, "--url", base, "--image", image,
                       "--clients", str(clients), "--seconds", str(args.seconds)]
                load.append({"clients_in": "a process of their own", **load_run(
                    svc, lambda: json.loads(subprocess.run(
                        cmd, check=True, capture_output=True, text=True,
                        timeout=args.seconds + 120).stdout))})
    finally:
        server.shutdown()
        server.server_close()
        svc.close()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip()
    result = {"card": card, "torch": torch.__version__, "overrides": args.overrides,
              "res": int(cfg.res), "max_batch": int(cfg.max_batch),
              "max_wait_ms": float(cfg.max_wait_ms), "fused_tta": ecfg.fused_tta,
              "crf_downsample": ecfg.crf.downsample, "buckets": buckets, "load": load}
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return result


if __name__ == "__main__":
    main()
