"""The Depth Anything V2 cell at a tiny size for the CPU tests: a ViT of 2
blocks 64 wide (4 heads of 16), patch 14, a 5 x 5 table resized to the
4 x 7 grid of a 56 x 98 image (down one way, up the other), hooks
(0, 0, 1, 1); DPT features 32 and projections (16, 32, 64, 64); the head's
32 channels as published."""

from __future__ import annotations

import json


def tiny_dav2_spec(cell: str = "dav2l-depth-b8-518x686") -> dict:
    """The spec `run.resolve` gives ``cell``, at a tiny size."""
    from benchmark.run import resolve

    spec = resolve(cell)
    cfg = json.loads(json.dumps(spec["config"]))
    cfg["encoder"].update(embed_dim=64, depth=2, num_heads=4, head_dim=16, pos_embed_grid=5)
    cfg["dpt"].update(hooks=[0, 0, 1, 1], features=32, out_channels=[16, 32, 64, 64])
    tr = dict(spec["traffic"], batch=2, height=56, width=98, ring=2, check_steps=2,
              trace_steps=1)
    return {**spec, "config": cfg, "traffic": tr}
