"""The serve cell's spec, built from its files: the cell is not in
`BENCHMARK.json` yet (PERF.md, Open questions), but its driver, traffic
mix, limits and metric readers are kept ready for it."""

from __future__ import annotations

import json

from benchmark.tests._tiny import BENCH

CELL = {"name": "vits8-serve-open", "config": "depthg-vits8-cocostuff27",
        "traffic": "serve-open-coco", "chips": 1}


def serve_spec() -> dict:
    cfg = json.loads((BENCH / "configs" / f"{CELL['config']}.json").read_text())
    tr = json.loads((BENCH / "traffic" / f"{CELL['traffic']}.json").read_text())
    return {"cell": CELL, "config": cfg, "traffic": tr, "end_to_end": [], "per_layer": []}
