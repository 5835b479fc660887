"""The knee of a serve cell: its open-loop load at a list of fixed rates,
one server for all of them, each rate for the same number of seconds.
Per rate it prints the requests sent, answered per second, p50 and p95
from due time, the largest lateness of a send, and the backlog (requests
due but unanswered) at the last due time. The highest rate whose answers
keep up and whose backlog does not grow is the knee; the cell's traffic
file takes four fifths of it as a fixed number.

    python3 -m benchmark.sweep --workload <serve cell> --rates 20,40,60 --seconds 10
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark.run import BENCH_DIR, load_module, resolve


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description="Open-loop rate sweep of a serve cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    spec = resolve(args.workload)
    cfg, tr = spec["config"], spec["traffic"]
    drv = load_module(BENCH_DIR / "drivers" / "serve.py", "benchmark_driver_serve")
    dev = torch.device("cuda", 0)
    service, server, port = drv.start_service(cfg, tr, args.seed, dev)
    bodies = drv.make_bodies(cfg, tr, args.seed, dev)
    try:
        for rate in [float(r) for r in args.rates.split(",")]:
            sched = drv.schedule(tr, args.seed, args.seconds, rate)
            out = drv.load(port, bodies, sched, [], tr["wait_s"])
            rows = out["rows"]
            st = drv.latency_stats(rows, tr["wait_s"], sched[-1][0])
            last_due = sched[-1][0]
            backlog = sum(r[2] is None or r[2] > last_due for r in rows)
            done = [r[2] for r in rows if r[2] is not None]
            print(json.dumps({"rate": rate, "sent": len(rows),
                              "answered_per_s": len(done) / max(max(done), 1e-9),
                              "p50_ms": st["p50_s"] * 1e3, "p95_ms": st["p95_s"] * 1e3,
                              "late_max_ms": (st["late_max_s"] or 0) * 1e3,
                              "backlog_at_last_due": backlog, "failed": st["failed"]}),
                  flush=True)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
