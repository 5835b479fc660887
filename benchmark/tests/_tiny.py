"""Tiny configurations for the benchmark's CPU tests: the shapes of the
real ones with every width and count cut so a step runs in a blink."""

from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def tiny_spec(cell: str) -> dict:
    """The spec `run.resolve` gives ``cell``, at a tiny size."""
    from benchmark.run import resolve

    spec = resolve(cell)
    cfg = json.loads(json.dumps(spec["config"]))
    cfg["backbone"].update(embed_dim=64, depth=2, num_heads=1, head_dim=64, pos_embed_grid=4)
    cfg["head"]["dim"] = 16
    cfg["eval"]["res"] = 64
    cfg["train"].update(res=64, batch=4, feature_samples=3, neg_samples=2)
    tr = dict(spec["traffic"])
    if tr["kind"] == "eval":
        tr.update(batch=2, ring=2, check_steps=2, trace_steps=1)
    else:
        tr.update(ring=3, trace_steps=1)
    return {**spec, "config": cfg, "traffic": tr}
