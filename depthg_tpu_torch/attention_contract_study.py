"""The attention kernel against another tree's, and against its contract, on the card.

    python -m depthg_tpu_torch.attention_contract_study --other OLD.cu [--rounds 5] [--out FILE]

Run from the repository's root. Builds ``OLD.cu`` (another tree's
``csrc/attention.cu``, e.g. from ``git show
<commit>:depthg_tpu_torch/csrc/attention.cu`` under ``build/``) beside the
package's kernel and, on the same inputs:

* ``shapes``: at every shape at which ``chip_smoke.py`` holds K1 to its
  plain version (``chip_smoke.k1_shapes``: the eval, padded eval, train,
  serving, KNN, MiDaS and BEiT-L bias shapes, the bias kernel's edges),
  whether the two outputs are equal bit for bit, and the
  device ms per call of each, queued behind a long product, the two in
  turns (package, other, other, package, ...) over ``--rounds`` rounds
  after ~2 s of warm-up (the median of each, and the mean over rounds of
  the ratio within a round);
* ``contract``: each kernel at the cases of fault F6 (``F6_CASES``: rows <
  N in a 256-row block's second round of sub-tiles that holds no row <
  n_valid), both dtypes, with and without a bias, its output written into
  memory that held NaN: rows >= n_valid exactly 0, the others within
  ``TOL`` of ``attention_plain``, no NaN (``tests/test_torch_poison.py``'s
  ``k1_contract``, the card tests' own check);
* ``ptxas``: the registers and spills of every kernel of both builds.

Prints one JSON line per case and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def ptxas_report(log: str) -> dict:
    """{kernel: its "Used ... registers" line and its spill line} of a ptxas -v log."""
    report, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("spill" in line or "Used" in line):
            report.setdefault(name, []).append(line.strip())
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True, help="another tree's attention.cu")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--out", default="", help="also write the JSON lines here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_contract_study needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from chip_smoke import k1_shapes
    from test_torch_poison import F6_CASES, k1_contract, padded_bias

    from depthg_tpu_torch.attention_bias_study import build_other, queued_ms
    from depthg_tpu_torch.ops import _build
    from depthg_tpu_torch.ops import attention as att

    _build.build(["attention"])
    fns = att.KERNEL.fn()
    other, other_log = build_other(Path(args.other), "contract_study")
    libs = {"package": fns.fwd, "other": other}
    lines = [{"ptxas": {"package": ptxas_report(_build.BUILD_LOG.get("attention", "")),
                        "other": ptxas_report(other_log)}, "other": args.other}]
    print(json.dumps(lines[0]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    busy = torch.empty(8192, 8192, device="cuda").normal_()
    for _ in range(100):  # ~2 s of work: the card leaves its idle clocks first
        busy @ busy
    del busy
    for name, dtype, b, n, nv, heads, bias_dtype in k1_shapes():
        qkv = torch.randn(b, n, 3 * 64 * heads, device="cuda", generator=gen).to(dtype)
        bias = None if bias_dtype is None else padded_bias(heads, n, bias_dtype, gen)
        out = torch.empty(b, n, heads, 64, device="cuda", dtype=dtype).permute(0, 2, 1, 3)
        q, k, v = att.split_qkv(qkv, heads)

        def call(lib, out=out, q=q, k=k, v=v, nv=nv, bias=bias):
            fns.fwd = libs[lib]
            att._launch(q, k, v, out, 64 ** -0.5, nv, bias)

        outs = {}
        for lib in libs:
            out.fill_(float("nan"))  # a row left unwritten is never equal
            call(lib)
            outs[lib] = out.clone()
        iters = 10 if dtype == torch.float32 and b * n > 50_000 else 40
        times = {lib: [] for lib in libs}
        for r in range(args.rounds):
            for lib in (("package", "other") if r % 2 == 0 else ("other", "package")):
                times[lib].append(queued_ms(lambda lib=lib: call(lib), iters))
        fns.fwd = libs["package"]
        med = {lib: statistics.median(t) for lib, t in times.items()}
        line = {"case": name, "dtype": str(dtype), "shape": [b, n, heads, 64], "n_valid": nv,
                "bias": None if bias is None else str(bias_dtype),
                "same_bits": bool(torch.equal(outs["package"], outs["other"])),
                "median_ms": med, "package_over_other": med["package"] / med["other"],
                "paired_ratio_mean": statistics.mean(
                    p / o for p, o in zip(times["package"], times["other"])),
                "rounds_ms": times, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del qkv, bias, out, q, k, v, outs
        torch.cuda.empty_cache()
    for n, nv, heads in F6_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            for bias_dtype in (None, dtype):
                qkv = torch.randn(2, n, 3 * 64 * heads, device="cuda", generator=gen).to(dtype)
                bias = None if bias_dtype is None else padded_bias(heads, n, bias_dtype, gen)
                res = {}
                for lib in libs:
                    fns.fwd = libs[lib]
                    res[lib] = k1_contract(att, qkv, heads, nv, bias)
                fns.fwd = libs["package"]
                line = {"contract": f"n{n}_valid{nv}", "dtype": str(dtype),
                        "shape": [2, n, heads, 64], "bias": bias is not None, **res,
                        "card": card}
                print(json.dumps(line), flush=True)
                lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
