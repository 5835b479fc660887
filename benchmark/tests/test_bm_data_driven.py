"""The harness takes a new cell, configuration, traffic mix and per-layer
metric by new files and `BENCHMARK.json` entries alone, and refuses to run
without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from benchmark.run import ROOT

NEW_METRIC = '''"""A metric added by a later change."""


def read(spec, out):
    return 100.0 * out["counts"]["steps"] / max(out["counts"]["window_s"], 1e-9)
'''

PROBE = r'''
import json, sys
import benchmark.run as r
spec = r.resolve("new-cell")
assert spec["config"]["name"] == "new-config", spec["config"]["name"]
assert spec["traffic"]["batch"] == 4
assert [m["name"] for m in spec["per_layer"]] == ["steps_rate.new"], spec["per_layer"]
reader = r.load_module(r.BENCH_DIR / "metrics" / "steps_rate.new.py", "m")
print(reader.read(spec, {"counts": {"steps": 3, "window_s": 2.0}}))
r.load_module(r.BENCH_DIR / "drivers" / (spec["traffic"]["kind"] + ".py"), "d")
'''


def _copy(tmp_path):
    dst = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def test_new_cell_config_mix_and_metric_by_new_files_only(tmp_path):
    dst = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (dst / "benchmark").rglob("*") if p.is_file()}
    cfg = json.loads((dst / "benchmark/configs/depthg-vits8-cocostuff27.json").read_text())
    cfg["name"] = "new-config"
    (dst / "benchmark/configs/new-config.json").write_text(json.dumps(cfg))
    mix = json.loads((dst / "benchmark/traffic/eval-ring-b16.json").read_text())
    mix["batch"] = 4
    (dst / "benchmark/traffic/new-mix.json").write_text(json.dumps(mix))
    (dst / "benchmark/metrics/steps_rate.new.py").write_text(NEW_METRIC)
    (dst / "benchmark/limits/new-cell.json").write_text('{"count_gap": 0, "label_gap": 0.1}')
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new-config", "source": "https://arxiv.org/abs/2309.12378",
                             "file": "benchmark/configs/new-config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new-mix", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("new-cell")
    bench["per_layer"].append({"name": "steps_rate.new", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "a test",
                               "moves": "eval_img_per_s", "workloads": ["new-cell"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=dst, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert float(out.stdout.strip()) == 150.0
    assert all(p.read_bytes() == b for p, b in before.items())  # no file there changed


def _bench_cmd(cwd):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine that has one
    cmd = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
    return subprocess.run(cmd + ["--workload", "vits8-eval-default", "--seed", str(2 ** 33),
                                 "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_exits_nonzero_without_a_result():
    out = _bench_cmd(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_exit_nonzero(tmp_path):
    out = _bench_cmd(_copy(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
