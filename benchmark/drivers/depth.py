"""Depth generation: the step `python -m depthg_tpu_torch.generate_depth
--model zoedepth` runs per bucket, `generate_depth.build`'s `infer` on a
batch (`zoedepth_infer`: reflect pad and the flip pass, each a BEiT-L
forward through the attention kernel with its relative-position bias, the
DPT decoder and the metric-bins head; depth and feats cast to float32),
over a ring of seeded synthetic batches resident on the device, back to
back. The model is the one `build` makes (`--allow_random`, at the
configuration's widths) and casts with `to_dtype`; the seed's float32
weights are then loaded into it strictly, each rounded to the model's
dtype as `to_dtype` rounds it. The host's PNG encoding and file writes are
not part of the step.

Traffic keys: `batch`, `height`, `width` (the bucket), `ring` (distinct
batches, cycled), `regions` (the scenes), `check_steps` (steps compared
with the reference after the window), `trace_steps`.

End-to-end: `eval_img_per_s` = images of every step launched in the window
over the window's host time, which ends in a synchronize; `setup_s` =
process start to the first timed step.

`correct`: for `check_steps` steps drawn from the seed, the plain float32
reference's depth on the same batch and weights (drawn again from the
seed) against what the timed step produced. `depth_gap`: the worst
image's 99th percentile of |d_prog - d_ref| over the reference image's
depth range. `png_gap`: the worst image's share of pixels whose 8-bit
value (the depth min-max normalized per image, as `write_one` writes it)
differs from the reference's by more than one step. A step whose output is
not [batch, 1, height, width] or not finite counts in `failed`; compared,
such an output reads `GAP_MAX` and every pixel apart.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import common, counting_depth
from benchmark.reference import zoedepth as zoe_ref
from benchmark.scenes import IMAGENET_MEAN, IMAGENET_STD, scene_batch
from benchmark.weights_zoedepth import make_state_dict

LIMITS = Path(__file__).resolve().parents[1] / "limits"
# what a gap reads when the output cannot be compared (wrong shape, not finite)
GAP_MAX = 1e6


def zoe_config(cfg: dict):
    """The port's ZoeConfig at the configuration's widths. A program whose
    BEiTConfig has no ``rel_pos_resize`` cannot be set to the released
    model's table resize, and fails here with a TypeError."""
    from depthg_tpu_torch.models.zoedepth.beit import BEiTConfig
    from depthg_tpu_torch.models.zoedepth.dpt import DPTConfig
    from depthg_tpu_torch.models.zoedepth.model import ZoeConfig

    bb, dpt, bins = cfg["beit"], cfg["dpt"], cfg["bins"]
    if bb["embed_dim"] != bb["num_heads"] * bb["head_dim"]:
        raise ValueError("embed_dim must be num_heads * head_dim")
    beit = BEiTConfig(patch_size=bb["patch_size"], embed_dim=bb["embed_dim"], depth=bb["depth"],
                      num_heads=bb["num_heads"], mlp_ratio=bb["mlp_ratio"], ln_eps=bb["ln_eps"],
                      pretrain_window=bb["pretrain_window"], hooks=tuple(bb["hooks"]),
                      rel_pos_resize=bb["rel_pos_resize"],
                      layer_scale_init=cfg["init"]["layer_scale"])
    decoder = DPTConfig(embed_dim=bb["embed_dim"], features=dpt["features"],
                        reassemble_channels=tuple(dpt["reassemble_channels"]),
                        project_readout=dpt["readout"] == "project")
    return ZoeConfig(n_bins=bins["n_bins"], bin_embedding_dim=bins["bin_embedding_dim"],
                     bin_centers_type=bins["bin_centers_type"], min_depth=cfg["min_depth"],
                     max_depth=cfg["max_depth"], n_attractors=tuple(bins["n_attractors"]),
                     attractor_alpha=bins["attractor_alpha"],
                     attractor_gamma=bins["attractor_gamma"],
                     attractor_kind=bins["attractor_kind"],
                     attractor_type=bins["attractor_type"], min_temp=bins["min_temp"],
                     max_temp=bins["max_temp"], inverse_midas=bins["inverse_midas"],
                     img_size=tuple(cfg["img_size"]), beit=beit, dpt=decoder,
                     n_midas_out=dpt["n_midas_out"])


def build_program(cfg: dict, seed: int, dev):
    """(infer, model): the CLI's `build` at the configuration's widths, its
    model holding the seed's weights."""
    from depthg_tpu_torch import generate_depth

    inf = cfg["infer"]
    if not (inf["pad_input"] and inf["flip_aug"]):
        raise ValueError("generate_depth runs zoedepth_infer with the pad and the flip")
    args = generate_depth.get_args_parser().parse_args(
        ["--model", "zoedepth", "--allow_random", "--dtype", inf["dtype"],
         "--attn_impl", inf["attn_impl"]])
    with contextlib.redirect_stdout(sys.stderr):  # its notice of random weights
        infer, model = generate_depth.build(args, dev, zoe_config(cfg))
    model.load_state_dict(make_state_dict(cfg, common.stream_seed(seed, "weights"), dev),
                          strict=True)
    return infer, model


def make_ring(tr: dict, seed: int, dev) -> list:
    """`ring` batches of [batch, 3, height, width] images in [0, 1]: the
    scenes of `benchmark.scenes` drawn square at the longer side, cropped."""
    gen = torch.Generator(device=dev).manual_seed(common.stream_seed(seed, "data"))
    h, w = tr["height"], tr["width"]
    mean = torch.tensor(IMAGENET_MEAN, device=dev)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=dev)[None, :, None, None]
    out = []
    for _ in range(tr["ring"]):
        img = scene_batch(gen, tr["batch"], max(h, w), tr["regions"], 1, 0.0)["img"]
        out.append((img * std + mean).clamp(0.0, 1.0)[:, :, :h, :w].contiguous())
    return out


def sound(depth: torch.Tensor, tr: dict) -> bool:
    """The step's output has the bucket's shape and is finite."""
    return tuple(depth.shape) == (tr["batch"], 1, tr["height"], tr["width"]) \
        and bool(torch.isfinite(depth).all())


def _png(d: torch.Tensor) -> torch.Tensor:
    """[B, P] depth -> the 8-bit values `write_one` writes."""
    lo, hi = d.amin(1, keepdim=True), d.amax(1, keepdim=True)
    return ((d - lo) / (hi - lo).clamp_min(1e-12) * 255).to(torch.uint8).int()


def gaps(prog: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(depth_gap, png_gap) of one step, the worst image of each."""
    if prog.shape != ref.shape:
        return GAP_MAX, 1.0
    p, r = prog.float().flatten(1), ref.float().flatten(1)
    span = (r.amax(1) - r.amin(1)).clamp_min(1e-12)
    diff = (p - r).abs()
    finite = torch.isfinite(diff).all(1)
    depth = torch.quantile(torch.where(finite[:, None], diff, 0.0), 0.99, dim=1) / span
    depth = torch.where(finite, depth, GAP_MAX).clamp_max(GAP_MAX)
    png = ((_png(torch.where(finite[:, None], p, r)) - _png(r)).abs() > 1).float().mean(1)
    png = torch.where(finite, png, 1.0)
    return float(depth.max()), float(png.max())


def worst(outs: dict, ref: dict) -> dict:
    got = [gaps(outs[i], ref[i]) for i in ref]
    return {"depth_gap": max(g[0] for g in got), "png_gap": max(g[1] for g in got)}


def reference_depth(cfg: dict, seed: int, ring: list, picks: list, dev, **opts) -> dict:
    """The reference's depth (weights drawn again from the seed) on the
    batches of the picked steps, by step."""
    sd = make_state_dict(cfg, common.stream_seed(seed, "weights"), dev)
    return {i: zoe_ref.depth_maps(sd, cfg, ring[i % len(ring)], **opts) for i in picks}


def run(spec: dict, seed: int, seconds: float, trace: bool, dev, t_start: float) -> dict:
    cfg, tr, cell = spec["config"], spec["traffic"], spec["cell"]
    limits = json.loads((LIMITS / f"{cell['name']}.json").read_text())
    infer, model = build_program(cfg, seed, dev)
    ring = make_ring(tr, seed, dev)

    def launch(i):
        return infer(ring[i % len(ring)])[0]

    for i in range(2):  # the first builds the kernels and the biases; the second runs warm
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
        "checks": {k: (v, limits[k]) for k, v in checks.items()},
        "memory_peak_bytes": peak, "trace": summary,
        "counts": {"steps": n, "window_s": window_s, "batch": batch,
                   "step_flops": counting_depth.step_flops(cfg, *size),
                   "attention_bound_s": counting_depth.step_attention_bound_s(cfg, *size)},
    }


def readings(spec: dict, seed: int, dev) -> dict:
    """The numbers `correct` compares, on the first `check_steps` batches of
    the seed's ring: the program's, the control's (the reference with fp8
    BEiT operands in the program's place) and each fault's, planted in the
    reference put in the program's place: the relative-position bias left
    out of every block, the last attractor stage skipped, the flip pass
    left out, and the second half of each batch left unwritten (zeros)."""
    from benchmark.reference.control import fp8_round

    cfg, tr = spec["config"], spec["traffic"]
    infer, model = build_program(cfg, seed, dev)
    ring = make_ring(tr, seed, dev)
    picks = list(range(tr["check_steps"]))
    outs = {i: infer(ring[i])[0] for i in picks}
    del model, infer
    common.free(dev)
    ref = reference_depth(cfg, seed, ring, picks, dev)

    def planted(**opts):
        return worst(reference_depth(cfg, seed, ring, picks, dev, **opts), ref)

    half = {i: torch.cat([d[: len(d) // 2], torch.zeros_like(d[len(d) // 2:])])
            for i, d in ref.items()}
    return {"program": worst(outs, ref), "control": planted(quantize=fp8_round),
            "faults": {"bias_dropped": planted(rel_bias=False),
                       "last_attractor_skipped":
                           planted(attractors=len(cfg["bins"]["n_attractors"]) - 1),
                       "flip_left_out": planted(flip=False),
                       "half_batch": worst(half, ref)}}
