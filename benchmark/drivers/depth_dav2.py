"""Depth generation with Depth Anything V2: the step `python -m
depthg_tpu_torch.generate_depth --model depth_anything_v2` runs per
bucket, `generate_depth.build`'s `infer` on a batch (one pass without a
flip: the normalization, the ViT-L/14 with its four normed taps through the
attention kernel without a bias, the DPT head with its resize to the input
size; the disparity cast to float32), over a ring of seeded synthetic
batches resident on the device, back to back. The model is the one `build`
makes (`--allow_random`, at the configuration's widths) and casts with
`to_dtype`; the seed's float32 weights, drawn under the released file's
names, then go through the port's loader of those names
(`convert.depth_anything_v2_state_dict`) and load strictly, each rounded
to the model's dtype as `to_dtype` rounds it. The host's PNG encoding and
file writes are not part of the step.

A program whose `generate_depth` offers no `--model depth_anything_v2`
fails at once with a ValueError.

Traffic keys: `batch`, `height`, `width` (the bucket: the model's input
rule for the cell's images), `ring` (distinct batches, cycled), `regions`
(the scenes), `check_steps` (steps compared with the reference after the
window), `trace_steps`.

End-to-end: `eval_img_per_s` = images of every step launched in the window
over the window's host time, which ends in a synchronize; `setup_s` =
process start to the first timed step.

`correct`: for `check_steps` steps drawn from the seed, the plain float32
reference's disparity (`benchmark/reference/depth_anything_v2.py`) on the
same batch and weights (drawn again from the seed) against what the timed
step produced: `depth_gap` as `drivers/depth.py` computes it (the worst
image's 99th percentile of the gap over the reference's range), the one
number the cell's limits file holds. `png_gap` (the worst image's share of
8-bit pixels more than one step apart) is no check: the program's and the
control's readings overlap on these weights, so no limit lies between them;
`readings()` reports it. A step whose output is not [batch, 1, height,
width] or not finite counts in `failed`.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import common, counting_dav2
from benchmark.drivers.depth import make_ring, sound, worst
from benchmark.reference import depth_anything_v2 as ref
from benchmark.weights_dav2 import make_state_dict

LIMITS = Path(__file__).resolve().parents[1] / "limits"
MODEL = "depth_anything_v2"


def dav2_config(cfg: dict):
    """The port's DepthAnythingV2Config at the configuration's widths."""
    from depthg_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from depthg_tpu_torch.models.depth_anything_v2 import DepthAnythingV2Config
    from depthg_tpu_torch.models.vit import ViTConfig

    enc, dpt, inp = cfg["encoder"], cfg["dpt"], cfg["input"]
    if enc["embed_dim"] != enc["num_heads"] * enc["head_dim"]:
        raise ValueError("embed_dim must be num_heads * head_dim")
    if (enc["interpolate_offset"], enc["interpolate_antialias"]) != (0.1, False):
        raise ValueError("the port's table resize is DINO's: offset 0.1, no antialias")
    if dpt["use_clstoken"] or dpt["head_features_2"] != 32:
        raise ValueError("the port's head has no readout projection and 32 channels")
    if torch.tensor(inp["mean"] + inp["std"]).tolist() != torch.tensor(
            [*IMAGENET_MEAN, *IMAGENET_STD]).tolist():
        raise ValueError("the port normalizes with ImageNet's mean and std")
    vit = ViTConfig(patch_size=enc["patch_size"], embed_dim=enc["embed_dim"], depth=enc["depth"],
                    num_heads=enc["num_heads"], mlp_ratio=enc["mlp_ratio"],
                    qkv_bias=enc["qkv_bias"], ln_eps=enc["ln_eps"],
                    img_size=enc["pos_embed_grid"] * enc["patch_size"],
                    layer_scale=enc["layer_scale"], pos_resize="dino")
    return DepthAnythingV2Config(vit=vit, hooks=tuple(dpt["hooks"]), features=dpt["features"],
                                 out_channels=tuple(dpt["out_channels"]),
                                 img_size=(inp["size"], inp["size"]))


def build_program(cfg: dict, seed: int, dev):
    """(infer, model): the CLI's `build` at the configuration's widths, its
    model holding the seed's weights."""
    from depthg_tpu_torch import generate_depth

    parser = generate_depth.get_args_parser()
    models = next(a.choices for a in parser._actions if a.dest == "model")
    if MODEL not in models:
        raise ValueError(f"generate_depth offers --model {models}, not {MODEL}")
    from depthg_tpu_torch.models.zoedepth.convert import depth_anything_v2_state_dict

    inf = cfg["infer"]
    args = parser.parse_args(["--model", MODEL, "--allow_random", "--dtype", inf["dtype"],
                              "--attn_impl", inf["attn_impl"]])
    with contextlib.redirect_stdout(sys.stderr):  # its notice of random weights
        infer, model = generate_depth.build(args, dev, dav2_config=dav2_config(cfg))
    sd = make_state_dict(cfg, common.stream_seed(seed, "weights"), dev)
    model.load_state_dict(depth_anything_v2_state_dict(sd), strict=True)
    return infer, model


def reference_depth(cfg: dict, seed: int, ring: list, picks: list, dev, **opts) -> dict:
    """The reference's disparity (weights drawn again from the seed) on the
    batches of the picked steps, by step."""
    sd = make_state_dict(cfg, common.stream_seed(seed, "weights"), dev)
    return {i: ref.disparity_maps(sd, cfg, ring[i % len(ring)], **opts) for i in picks}


def run(spec: dict, seed: int, seconds: float, trace: bool, dev, t_start: float) -> dict:
    cfg, tr, cell = spec["config"], spec["traffic"], spec["cell"]
    limits = json.loads((LIMITS / f"{cell['name']}.json").read_text())
    infer, model = build_program(cfg, seed, dev)
    ring = make_ring(tr, seed, dev)

    def launch(i):
        return infer(ring[i % len(ring)])[0]

    for i in range(2):  # the first builds the kernels; the second runs warm
        launch(i)
    common.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    outs = []
    n, window_s = common.window(lambda i: outs.append(launch(i)), seconds, dev)
    peak = common.peak_bytes(dev)
    summary = None
    if trace:
        from benchmark import trace as trace_lib

        k = iter(range(n, n + tr["trace_steps"]))
        summary = trace_lib.profile(lambda: launch(next(k)), tr["trace_steps"], dev)

    bad = sum(not sound(d, tr) for d in outs)
    picks = common.sample_indices(seed, n, tr["check_steps"])
    kept = {i: outs[i] for i in picks}
    del model, infer, outs
    common.free(dev)
    checks = worst(kept, reference_depth(cfg, seed, ring, picks, dev))
    batch = tr["batch"]
    size = (batch, tr["height"], tr["width"])
    return {
        "metrics": {"eval_img_per_s": n * batch / window_s, "setup_s": setup_s},
        "attempted": n, "failed": bad,
        "checks": {k: (checks[k], limit) for k, limit in limits.items()},
        "memory_peak_bytes": peak, "trace": summary,
        "counts": {"steps": n, "window_s": window_s, "batch": batch,
                   "step_flops": counting_dav2.step_flops(cfg, *size),
                   "attention_bound_s": counting_dav2.step_attention_bound_s(cfg, *size)},
    }


def readings(spec: dict, seed: int, dev) -> dict:
    """The numbers `correct` compares, on the first `check_steps` batches of
    the seed's ring: the program's, the control's (the reference with fp8
    operands in every product in the program's place) and each fault's,
    planted in the reference put in the program's place: the blocks' raw
    outputs tapped (no final norm, as MiDaS taps them), the first hook one
    block late, the ImageNet normalization skipped, the LayerScale gammas
    left out, and the second half of each batch left unwritten (zeros)."""
    from benchmark.reference.control import fp8_round

    cfg, tr = spec["config"], spec["traffic"]
    infer, model = build_program(cfg, seed, dev)
    ring = make_ring(tr, seed, dev)
    picks = list(range(tr["check_steps"]))
    outs = {i: infer(ring[i])[0] for i in picks}
    del model, infer
    common.free(dev)
    base = reference_depth(cfg, seed, ring, picks, dev)

    def planted(**opts):
        return worst(reference_depth(cfg, seed, ring, picks, dev, **opts), base)

    hooks = list(cfg["dpt"]["hooks"])
    half = {i: torch.cat([d[: len(d) // 2], torch.zeros_like(d[len(d) // 2:])])
            for i, d in base.items()}
    return {"program": worst(outs, base), "control": planted(quantize=fp8_round),
            "faults": {"raw_taps": planted(norm_taps=False),
                       "first_hook_late": planted(hooks=[hooks[0] + 1] + hooks[1:]),
                       "not_normalized": planted(normalize=False),
                       "layer_scale_left_out": planted(layer_scale=False),
                       "half_batch": worst(half, base)}}
