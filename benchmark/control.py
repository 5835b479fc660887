"""Readings behind the limits of `correct`: for each seed, the numbers a
cell compares as the program gives them, as the lower-precision control
gives them (the reference in the next precision down in the program's
place), and as each planted fault gives them. One JSON line per seed.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--out FILE]

On the chip this runs at the cell's own size; `benchmark/tests` runs it
at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark.run import BENCH_DIR, load_module, resolve


def readings(spec: dict, seeds: list, dev) -> list:
    kind = spec["traffic"]["kind"]
    driver = load_module(BENCH_DIR / "drivers" / f"{kind}.py", f"benchmark_driver_{kind}")
    return [{"seed": s, **driver.readings(spec, s, dev)} for s in seeds]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description="Program, control and fault readings per seed.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--out", default=None, help="append the JSON lines to this file too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = resolve(args.workload)
    for row in readings(spec, [int(s) for s in args.seeds.split(",")], torch.device("cuda", 0)):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
