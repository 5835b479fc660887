"""Offline evaluation: `inference.make_eval_step` over a ring of seeded
synthetic batches resident on the device, back to back.

Traffic keys: `batch`, `ring` (distinct batches, cycled), `regions` and
`unlabelled` (the scenes), `check_steps` (steps compared with the
reference after the window), `trace_steps`.

End-to-end: `eval_img_per_s` = images of every step launched in the
window over the window's host time, which ends in a synchronize;
`setup_s` = process start to the first timed step.

`correct`: every step's confusion blocks count exactly the labelled
pixels of its batch (`count_gap`, limit 0), and for `check_steps` steps
drawn from the seed the plain reference's blocks on the same batch and
weights differ by at most the limit in the share of pixels whose label
moved (`label_gap` = L1 distance of the blocks / 2 / labelled pixels,
the worst of both probes and all steps compared).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from benchmark import common, counting
from benchmark.reference import eval as eval_ref
from benchmark.scenes import scene_batch
from benchmark.weights import make_state_dict

LIMITS = Path(__file__).resolve().parents[1] / "limits"


def eval_config(cfg: dict):
    from depthg_tpu_torch.inference import EvalConfig
    from depthg_tpu_torch.ops.crf import CRFConfig

    ev = cfg["eval"]
    return EvalConfig(n_classes=cfg["n_classes"], extra_clusters=cfg["extra_clusters"],
                      run_crf=True, label_res=ev["res"], cluster_alpha=ev["cluster_alpha"],
                      crf=CRFConfig(**ev["crf"]), backbone_dtype=ev["backbone_dtype"],
                      fused_tta=ev["fused_tta"])


def make_ring(cfg: dict, tr: dict, seed: int, dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(common.stream_seed(seed, "data"))
    return [scene_batch(gen, tr["batch"], cfg["eval"]["res"], tr["regions"], cfg["n_classes"],
                        tr["unlabelled"]) for _ in range(tr["ring"])]


def labelled(batch: dict, n_classes: int) -> int:
    lab = batch["label"]
    return int(((lab >= 0) & (lab < n_classes)).sum())


def label_gap(prog, ref, n_pixels: int) -> float:
    """Worst probe's share of labelled pixels whose (pred, actual) moved."""
    return max(float((p.cpu() - r.cpu()).abs().sum()) / 2.0 / n_pixels
               for p, r in zip(prog, ref))


def reference_blocks(cfg: dict, seed: int, ring: list, picks: list, dev,
                     quantize=None, alter=None) -> dict:
    """The reference's blocks (weights drawn again from the seed) on the
    batches of the picked steps, by step."""
    sd = make_state_dict(cfg, common.stream_seed(seed, "weights"), dev)
    with torch.no_grad():
        return {i: eval_ref.eval_blocks(sd, cfg, ring[i % len(ring)]["img"],
                                        ring[i % len(ring)]["label"], quantize=quantize,
                                        alter=alter)
                for i in picks}


def worst_gap(cfg: dict, ring: list, outs: dict, ref: dict) -> float:
    return max(label_gap(outs[i], ref[i], labelled(ring[i % len(ring)], cfg["n_classes"]))
               for i in ref)


def build_program(cfg: dict, seed: int, dev):
    """(model, step) of the port with the seed's weights."""
    from depthg_tpu_torch.inference import make_eval_step

    common.numerics()
    sd = make_state_dict(cfg, common.stream_seed(seed, "weights"), dev)
    model = common.segmenter(cfg, sd).eval()
    return model, make_eval_step(eval_config(cfg))


def run(spec: dict, seed: int, seconds: float, trace: bool, dev, t_start: float) -> dict:
    cfg, tr, cell = spec["config"], spec["traffic"], spec["cell"]
    limits = json.loads((LIMITS / f"{cell['name']}.json").read_text())
    model, step = build_program(cfg, seed, dev)
    ring = make_ring(cfg, tr, seed, dev)
    n_valid = [labelled(b, cfg["n_classes"]) for b in ring]

    def launch(i):
        b = ring[i % len(ring)]
        return step(model, b["img"], b["label"])

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

    count_gap = 0
    bad = 0
    for i, blocks in enumerate(outs):
        gap = max(abs(int(b.sum()) - n_valid[i % len(ring)]) for b in blocks)
        count_gap = max(count_gap, gap)
        bad += gap > 0
    picks = common.sample_indices(seed, n, tr["check_steps"])
    kept = {i: tuple(b.cpu() for b in outs[i]) for i in picks}
    del model, step, outs
    common.free(dev)
    gap = worst_gap(cfg, ring, kept, reference_blocks(cfg, seed, ring, picks, dev))
    batch = tr["batch"]
    return {
        "metrics": {"eval_img_per_s": n * batch / window_s, "setup_s": setup_s},
        "attempted": n, "failed": bad,
        "checks": {"count_gap": (count_gap, limits["count_gap"]),
                   "label_gap": (gap, limits["label_gap"])},
        "memory_peak_bytes": peak, "trace": summary,
        "counts": {"steps": n, "window_s": window_s, "batch": batch,
                   "step_flops": counting.eval_step_flops(cfg, batch),
                   "attention_bound_s": counting.eval_attention_bound_s(cfg, batch)},
    }



def readings(spec: dict, seed: int, dev) -> dict:
    """The numbers `correct` compares, on the first `check_steps` batches of
    the seed's ring: the program's, the control's (the reference in fp8 in
    the program's place) and each fault's, planted in the reference put in
    the program's place: half of each batch left out (its blocks count the
    first half's pixels), and the first image's labels altered where they
    are produced."""
    from benchmark.reference.control import fp8_round

    cfg, tr = spec["config"], spec["traffic"]
    n = cfg["n_classes"]
    model, step = build_program(cfg, seed, dev)
    ring = make_ring(cfg, tr, seed, dev)
    picks = list(range(tr["check_steps"]))
    outs = {i: tuple(b.cpu() for b in step(model, ring[i]["img"], ring[i]["label"]))
            for i in picks}
    counts = max(abs(int(b.sum()) - labelled(ring[i], n)) for i in picks for b in outs[i])
    del model, step
    common.free(dev)
    ref = reference_blocks(cfg, seed, ring, picks, dev)
    ctrl = reference_blocks(cfg, seed, ring, picks, dev, quantize=fp8_round)

    def alter_first(preds):
        return torch.cat([(preds[:1] + 1) % n, preds[1:]])

    altered = reference_blocks(cfg, seed, ring, picks, dev, alter=alter_first)
    half = max(labelled(ring[i], n) - labelled({"label": ring[i]["label"][: tr["batch"] // 2]}, n)
               for i in picks)
    return {"program": {"label_gap": worst_gap(cfg, ring, outs, ref), "count_gap": counts},
            "control": {"label_gap": worst_gap(cfg, ring, ctrl, ref)},
            "faults": {"half_batch": {"count_gap": half},
                       "answer_altered": {"label_gap": worst_gap(cfg, ring, altered, ref)}}}
