"""The depth cell at a tiny size for the CPU tests: BEiT of 4 blocks, 64
wide, 4 heads, a hook at every block, a 6 x 6 pretraining window that a
64 x 96 image (padded to 96 x 136, prepped to 64 x 96: a 4 x 6 grid)
resizes to a non-square one; DPT features 32; 16 bins; attractors
(4, 2, 2, 1); the heads' hidden widths as published."""

from __future__ import annotations

import json


def tiny_depth_spec(cell: str = "zoedepth-gen-b8") -> dict:
    """The spec `run.resolve` gives ``cell``, at a tiny size."""
    from benchmark.run import resolve

    spec = resolve(cell)
    cfg = json.loads(json.dumps(spec["config"]))
    cfg["beit"].update(embed_dim=64, depth=4, num_heads=4, head_dim=16, pretrain_window=6,
                       hooks=[0, 1, 2, 3])
    cfg["dpt"].update(features=32, reassemble_channels=[16, 32, 64, 64])
    # the heads' hidden widths stay the published ones: the port fixes them
    cfg["bins"].update(n_bins=16, bin_embedding_dim=16, n_attractors=[4, 2, 2, 1])
    cfg["img_size"] = [64, 96]
    tr = dict(spec["traffic"], batch=2, height=64, width=96, ring=2, check_steps=2,
              trace_steps=1)
    return {**spec, "config": cfg, "traffic": tr}
