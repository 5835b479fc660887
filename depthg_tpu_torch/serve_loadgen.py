"""Closed-loop load generator for ``python -m depthg_tpu_torch.serve``.

Drives the serving endpoint with N concurrent clients for a fixed duration
and prints ONE JSON line: offered concurrency, achieved img/s, client-side
latency quantiles, and the server's own /metrics snapshot (batch occupancy,
pad fraction). The client side is deliberately dumb — each thread posts the
same JPEG bytes in a loop — so the number measures the serving stack
(batching window + fused device step), not client complexity.

    python -m depthg_tpu_torch.serve_loadgen --url http://127.0.0.1:8080 \
        --image /tmp/serve_test.jpg --clients 8 --seconds 30
"""

import argparse
import json
import sys
import threading
import time
import urllib.request


def run(url: str, body: bytes, clients: int, seconds: float,
        fmt: str = "npz") -> dict:
    stop = time.monotonic() + seconds
    lock = threading.Lock()
    latencies: list[float] = []
    errors = [0]

    def worker():
        while time.monotonic() < stop:
            t0 = time.monotonic()
            req = urllib.request.Request(
                f"{url}/v1/segment?format={fmt}", data=body, method="POST")
            try:
                urllib.request.urlopen(req, timeout=120).read()
            except Exception:  # noqa: BLE001 — counted, run continues
                with lock:
                    errors[0] += 1
                continue
            with lock:
                latencies.append((time.monotonic() - t0) * 1e3)

    threads = [threading.Thread(target=worker) for _ in range(clients)]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start

    lat = sorted(latencies)
    q = lambda p: round(lat[min(len(lat) - 1, int(p * len(lat)))], 2) if lat else None  # noqa: E731
    server = json.loads(urllib.request.urlopen(f"{url}/metrics").read())
    return {
        "clients": clients,
        "seconds": round(wall, 2),
        "completed": len(lat),
        "errors": errors[0],
        "img_per_sec": round(len(lat) / wall, 2),
        "latency_ms_p50": q(0.50),
        "latency_ms_p90": q(0.90),
        "latency_ms_p99": q(0.99),
        "server_metrics": server,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default="http://127.0.0.1:8080")
    ap.add_argument("--image", required=True, help="image file to POST")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--format", default="npz")
    args = ap.parse_args(argv)
    with open(args.image, "rb") as f:
        body = f.read()
    print(json.dumps(run(args.url, body, args.clients, args.seconds,
                         args.format)))


if __name__ == "__main__":
    main(sys.argv[1:])
