"""Offline evaluation with a DINOv2 backbone: the step `python -m
depthg_tpu_torch.eval_segmentation` runs with `model_type` the
configuration's `backbone.arch` (`dinov2_vitg14_reg`) and
`dino_patch_size` 14, `inference.make_eval_step` on a `Segmenter` built
from `inference.fcfg_from_run_cfg` (the preset's widths checked against the
configuration's), over a ring of seeded synthetic batches resident on the
device, back to back. Everything but the backbone is `drivers/eval.py`'s:
its configuration of the step, ring, counts and label gaps are imported.

Traffic keys: as `eval`'s.

End-to-end: `eval_img_per_s` and `setup_s`, as `eval`'s.

`correct`: `count_gap` and `label_gap` as `eval`'s (the reference is
`benchmark/reference/vit_dinov2.py` with `eval.py`'s head, probes, CRF
and blocks), and `feat_gap`: on the batches of the `check_steps` steps
drawn from the seed, the worst image's relative L2 distance between the
program's patch features and the reference's, over both flip-TTA passes.
The program's come from `featurizer.backbone_features`, the function the
step calls, with the same weights, called after the window on the batch
and its mirror stacked as the fused step stacks them (one [2B] call, so
K1's block plan at the timed batch). It sees a fault confined to the
backbone that the CRF and the argmax would hide.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from benchmark import common, counting_dinov2
from benchmark.drivers import eval as eval_driver
from benchmark.reference import vit_dinov2 as ref
from benchmark.weights_dinov2 import make_state_dict

LIMITS = Path(__file__).resolve().parents[1] / "limits"


def featurizer_config(cfg: dict):
    """The eval CLI's featurizer config for the configuration's backbone
    and head (`inference.fcfg_from_run_cfg`), its preset checked against
    the configuration's widths."""
    from depthg_tpu_torch.inference import fcfg_from_run_cfg
    from depthg_tpu_torch.models.vit import swiglu_hidden

    bb, head = cfg["backbone"], cfg["head"]
    fcfg = fcfg_from_run_cfg({"model_type": bb["arch"], "dino_patch_size": bb["patch_size"],
                              "dino_feat_type": head["feat_type"],
                              "projection_type": head["projection_type"], "dim": head["dim"],
                              "dropout": head["dropout"]})
    vit = fcfg.vit
    got = {"patch_size": vit.patch_size, "embed_dim": vit.embed_dim, "depth": vit.depth,
           "num_heads": vit.num_heads, "head_dim": vit.embed_dim // vit.num_heads,
           "ffn": vit.ffn, "ffn_hidden": swiglu_hidden(vit), "n_registers": vit.n_registers,
           "layer_scale": vit.layer_scale, "qkv_bias": vit.qkv_bias, "ln_eps": vit.ln_eps,
           "pos_embed_grid": vit.img_size // vit.patch_size, "pos_resize": vit.pos_resize}
    wrong = {k: (v, bb[k]) for k, v in got.items() if v != bb[k]}
    if wrong:
        raise ValueError(f"preset {bb['arch']} differs from the configuration: {wrong}")
    return fcfg


def build_program(cfg: dict, seed: int, dev):
    """(model, step) of the port with the seed's weights."""
    from depthg_tpu_torch.inference import Segmenter, make_eval_step

    common.numerics()
    fcfg = featurizer_config(cfg)
    sd = make_state_dict(cfg, common.stream_seed(seed, "weights"), dev)
    with torch.device("meta"):
        model = Segmenter(fcfg, cfg["n_classes"], cfg["n_classes"] + cfg["extra_clusters"])
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval(), make_eval_step(eval_driver.eval_config(cfg))


def program_features(model, cfg: dict, ring: list, picks: list) -> dict:
    """The program's patch features of the picked steps' batches and their
    mirrors, [2B, D, h, w] by step, from the backbone calls the step makes
    (`inference.tta_code`: one stacked call under `fused_tta`, else one a
    pass)."""
    from depthg_tpu_torch.models.featurizer import backbone_features

    ecfg = eval_driver.eval_config(cfg)

    def features(img):
        return backbone_features(model.net, img, ecfg.precision,
                                 backbone_dtype=ecfg.backbone_dtype)[0]

    def both(img):
        flipped = torch.flip(img, dims=[-1])
        if ecfg.fused_tta:
            return features(torch.cat([img, flipped]))
        return torch.cat([features(img), features(flipped)])

    with torch.inference_mode():
        return {i: both(ring[i % len(ring)]["img"]) for i in picks}


def reference(cfg: dict, seed: int, ring: list, picks: list, dev, quantize=None, alter=None,
              **fault) -> dict:
    """The reference's (blocks, features) (weights drawn again from the
    seed) on the batches of the picked steps, by step."""
    sd = make_state_dict(cfg, common.stream_seed(seed, "weights"), dev)
    with torch.no_grad():
        return {i: ref.eval_blocks(sd, cfg, ring[i % len(ring)]["img"],
                                   ring[i % len(ring)]["label"], quantize, alter, **fault)
                for i in picks}


def feat_gap(prog: dict, got: dict) -> float:
    """The worst image's |f_prog - f_ref| / |f_ref| over the picked steps."""
    worst = 0.0
    for i, (_, r) in got.items():
        p, r = prog[i].float().flatten(1), r.float().flatten(1)
        worst = max(worst, float(((p - r).norm(dim=1) / r.norm(dim=1)).max()))
    return worst


def gaps(cfg: dict, ring: list, blocks: dict, feats: dict, got: dict) -> dict:
    """label_gap and feat_gap of (blocks, features) by step against the
    reference's ``got``."""
    ref_blocks = {i: b for i, (b, _) in got.items()}
    return {"label_gap": eval_driver.worst_gap(cfg, ring, blocks, ref_blocks),
            "feat_gap": feat_gap(feats, got)}


def run(spec: dict, seed: int, seconds: float, trace: bool, dev, t_start: float) -> dict:
    cfg, tr, cell = spec["config"], spec["traffic"], spec["cell"]
    limits = json.loads((LIMITS / f"{cell['name']}.json").read_text())
    model, step = build_program(cfg, seed, dev)
    ring = eval_driver.make_ring(cfg, tr, seed, dev)
    n_valid = [eval_driver.labelled(b, cfg["n_classes"]) for b in ring]

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
    feats = program_features(model, cfg, ring, picks)
    del model, step, outs
    common.free(dev)
    checks = gaps(cfg, ring, kept, feats, reference(cfg, seed, ring, picks, dev))
    batch = tr["batch"]
    return {
        "metrics": {"eval_img_per_s": n * batch / window_s, "setup_s": setup_s},
        "attempted": n, "failed": bad,
        "checks": {"count_gap": (count_gap, limits["count_gap"]),
                   **{k: (v, limits[k]) for k, v in checks.items()}},
        "memory_peak_bytes": peak, "trace": summary,
        "counts": {"steps": n, "window_s": window_s, "batch": batch,
                   "step_flops": counting_dinov2.eval_step_flops(cfg, batch),
                   "attention_bound_s": counting_dinov2.eval_attention_bound_s(cfg, batch)},
    }


# the backbone faults planted in the reference (`vit_dinov2.vit_features`'s keywords)
FAULTS = {"registers_left_out": {"registers": False},
          "layer_scale_left_out": {"layer_scale": False},
          "gate_as_gelu": {"gate": "gelu"},
          "table_without_antialias": {"antialias": False}}


def readings(spec: dict, seed: int, dev) -> dict:
    """The numbers `correct` compares, on the first `check_steps` batches of
    the seed's ring: the program's, the control's (the reference with fp8
    backbone operands in the program's place) and each fault's, planted in
    the reference put in the program's place: `FAULTS` in the backbone,
    half of each batch left out (its blocks count the first half's
    pixels), and the first image's labels altered where they are
    produced."""
    from benchmark.reference.control import fp8_round

    cfg, tr = spec["config"], spec["traffic"]
    n = cfg["n_classes"]
    model, step = build_program(cfg, seed, dev)
    ring = eval_driver.make_ring(cfg, tr, seed, dev)
    picks = list(range(tr["check_steps"]))
    outs = {i: tuple(b.cpu() for b in step(model, ring[i]["img"], ring[i]["label"]))
            for i in picks}
    counts = max(abs(int(b.sum()) - eval_driver.labelled(ring[i], n))
                 for i in picks for b in outs[i])
    feats = program_features(model, cfg, ring, picks)
    del model, step
    common.free(dev)
    sound = reference(cfg, seed, ring, picks, dev)

    def planted(**opts):
        got = reference(cfg, seed, ring, picks, dev, **opts)
        return gaps(cfg, ring, {i: b for i, (b, _) in got.items()},
                    {i: f for i, (_, f) in got.items()}, sound)

    def alter_first(preds):
        return torch.cat([(preds[:1] + 1) % n, preds[1:]])

    half = max(eval_driver.labelled(ring[i], n)
               - eval_driver.labelled({"label": ring[i]["label"][: tr["batch"] // 2]}, n)
               for i in picks)
    altered = planted(alter=alter_first)
    return {"program": {**gaps(cfg, ring, outs, feats, sound), "count_gap": counts},
            "control": planted(quantize=fp8_round),
            "faults": {**{name: planted(**fault) for name, fault in FAULTS.items()},
                       "half_batch": {"count_gap": half},
                       "answer_altered": {"label_gap": altered["label_gap"]}}}
