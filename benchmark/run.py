"""The benchmark of depthg_tpu_torch: one run of one cell on one process.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell in `BENCHMARK.json`,
its configuration in `benchmark/configs/<config>.json`, its traffic in
`benchmark/traffic/<traffic>.json`, whose `kind` names the driver
`benchmark/drivers/<kind>.py`, and each per-layer metric's reader in
`benchmark/metrics/<metric>.py`. Adding a cell, a configuration, a mix
or a metric adds files and entries; no file here changes.

The run prints, as the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device`, with
`--trace 1` also `breakdown`, and last `checks`: each number compared
for `correct` beside its limit. The same checks are the last lines of
standard error. Without a CUDA device (or with fewer than the cell asks
for) it exits 2 and prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # before any heavy import: set-up counts from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# module top-level names that must not be loaded (compared whole: the
# port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "depthg_tpu")


class RunError(Exception):
    """A run that cannot produce a result; the message goes to stderr."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by path (names hold dots and dashes)."""
    if not path.is_file():
        raise RunError(f"no such file: {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(workload: str, bench: dict | None = None) -> dict:
    """The cell with its configuration, traffic and metric entries."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[cell["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")

    def mine(metric):
        return cell["name"] in metric.get("workloads", [cell["name"]])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in e2e_names and mine(m)]
    return {"cell": cell, "config": config, "traffic": traffic, "end_to_end": e2e,
            "per_layer": per_layer}


def verdict(checks: dict) -> bool:
    """`correct`: every number compared lies within its limit."""
    return all(value <= limit for value, limit in checks.values())


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_info(dev) -> dict:
    import subprocess

    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1}
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"], capture_output=True, text=True, timeout=30,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def run(args) -> dict:
    spec = resolve(args.workload)
    cell, traffic = spec["cell"], spec["traffic"]
    # kernel caches at fixed paths inside the checkout
    cache = ROOT / "build" / "benchmark"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        raise RunError(f"cell {cell['name']} needs {cell['chips']} CUDA device(s); "
                       f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                       f"device_count={torch.cuda.device_count()}")
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    driver = load_module(BENCH_DIR / "drivers" / f"{traffic['kind']}.py",
                         f"benchmark_driver_{traffic['kind']}")
    out = driver.run(spec, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     dev=dev, t_start=T_START)
    device = card_info(dev)
    device["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    if args.trace:
        tr = out["trace"]
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        metrics = {}
        for m in spec["per_layer"]:
            reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                                 "benchmark_metric_" + m["name"].replace(".", "_"))
            value = reader.read(spec, out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"breakdown": {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
        extra = {}
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    return {"correct": verdict(out["checks"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device, **extra,
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
