"""The DINOv2 eval cell at a tiny size for the CPU tests: 3 blocks 64 wide,
4 heads of 16, 2 registers, the SwiGLU hidden width by the published
formula (176), patch 14 and a 5 x 5 position table, which a 56-px image
(a 4 x 4 grid) resizes down; head dim 16; the block linears drawn at std
0.1 (the queries and keys at 0.2), which spreads each token's products as
0.02 (0.04) does at the published width (0.02 sqrt(1536 / 64)).
`drivers/eval_dinov2.py` builds the backbone from the preset its
configuration names, so the tests put these widths under that preset's
name (`tiny_preset`)."""

from __future__ import annotations

import json

TINY = dict(embed_dim=64, depth=3, num_heads=4, n_registers=2)
PRESET = dict(patch_size=14, img_size=70, layer_scale=True, ffn="swiglu", pos_resize="dinov2",
              **TINY)


def tiny_preset(monkeypatch) -> None:
    """Give the configuration's preset name the tiny widths for one test."""
    from depthg_tpu_torch.models import vit

    monkeypatch.setitem(vit.VIT_PRESETS, "dinov2_vitg14_reg", PRESET)


def tiny_dinov2_spec(cell: str = "vitg14reg-eval-b16-448", res: int = 56) -> dict:
    """The spec `run.resolve` gives ``cell``, at a tiny size."""
    from benchmark.run import resolve

    spec = resolve(cell)
    cfg = json.loads(json.dumps(spec["config"]))
    cfg["backbone"].update(head_dim=16, ffn_hidden=176, pos_embed_grid=5, **TINY)
    cfg["init"].update(linear_std=0.1, qk_std=0.2)
    cfg["head"]["dim"] = 16
    cfg["eval"]["res"] = res
    tr = dict(spec["traffic"], batch=2, ring=2, check_steps=2, trace_steps=1)
    return {**spec, "config": cfg, "traffic": tr}
