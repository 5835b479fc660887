"""Training: `train.step.train_step` at the configuration's recipe over a
ring of seeded synthetic batches (image, KNN positive, both depth maps,
labels) resident on the device. Every step seeds the step generator
(dropout masks, the negatives' permutations) from (seed, step), and every
step's float inputs carry the previous step's loss times zero, so each
step waits for the one before it (a NaN would travel on).

Traffic keys: `ring`, `regions`, `unlabelled`, `trace_steps`; the batch
and resolution are the configuration's (`train.batch`, `train.res`).

End-to-end: `train_step_ms` = the window's host time, which ends in a
synchronize, over every step launched in it; `setup_s` = process start to
the first timed step.

`correct`: set-up builds the one train state and drives it through its
first three steps with the window's own call and feed, on three distinct
batches; the plain reference follows those steps from the same weights.
Compared: each step's loss (`loss_gap`, relative, the worst step), the
first step's gradient norm per leaf as Adam holds it after one step
(`grad_gap`, the worst leaf), and the parameters' change over the three
steps per leaf (`update_gap_median`, the median leaf), each leaf's gap of
norms over the larger of its reference norm and the median leaf's.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both.
"""

from __future__ import annotations

import json
import statistics
import time
from pathlib import Path

import torch

from benchmark import common, counting
from benchmark.reference import train as train_ref
from benchmark.scenes import scene_batch
from benchmark.weights import make_state_dict

LIMITS = Path(__file__).resolve().parents[1] / "limits"
CHECK_STEPS = 3


def hparams(cfg: dict):
    from depthg_tpu_torch.train import losses as loss_lib
    from depthg_tpu_torch.train.step import TrainHParams

    tc = cfg["train"]
    hp = TrainHParams(n_classes=cfg["n_classes"], extra_clusters=cfg["extra_clusters"],
                      pos_inter_weight=tc["pos_inter_weight"],
                      pos_intra_weight=tc["pos_intra_weight"],
                      neg_inter_weight=tc["neg_inter_weight"],
                      correspondence_weight=tc["correspondence_weight"],
                      lr=tc["lr"], probe_lr=tc["probe_lr"], use_depth=True,
                      backbone_dtype=tc["backbone_dtype"])
    lcfg = loss_lib.CorrLossConfig(
        feature_samples=tc["feature_samples"], neg_samples=tc["neg_samples"],
        pos_intra_shift=tc["pos_intra_shift"], pos_inter_shift=tc["pos_inter_shift"],
        neg_inter_shift=tc["neg_inter_shift"], depth_feat_shift=tc["depth_feat_shift"],
        pointwise=tc["pointwise"], zero_clamp=tc["zero_clamp"],
        depth_sampling=tc["depth_sampling"],
        depth_feat_correlation_loss=tc["depth_feat_correlation_loss"])
    return hp, lcfg


def make_ring(cfg: dict, tr: dict, seed: int, dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(common.stream_seed(seed, "data"))
    tc = cfg["train"]
    ring = []
    for _ in range(tr["ring"]):
        a, p = (scene_batch(gen, tc["batch"], tc["res"], tr["regions"], cfg["n_classes"],
                            tr["unlabelled"]) for _ in range(2))
        ring.append({"img": a["img"], "label": a["label"], "depth": a["depth"],
                     "img_pos": p["img"], "depth_pos": p["depth"]})
    return ring


def leaf_gaps(prog: dict, ref: dict, keep) -> list:
    """Per kept leaf, |norm(prog) - norm(ref)| over max(norm(ref), the
    median leaf's norm)."""
    norms = {k: float(v.norm()) for k, v in ref.items()}
    med = statistics.median(norms.values())
    return [abs(float(prog[k].norm()) - norms[k]) / max(norms[k], med, 1e-30) for k in keep]


def kept_leaves(ref_grads: dict) -> list:
    norms = {k: float(v.norm()) for k, v in ref_grads.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def compare(prog: dict, ref: dict) -> dict:
    """loss_gap, grad_gap and update_gap_median of a program's (or a stand-in's)
    first steps against the reference's (both as `run_steps` returns)."""
    keep = kept_leaves(ref["grads"])
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": max(leaf_gaps(prog["grads"], ref["grads"], keep)),
        # the median leaf: the worst leaf's change is the cluster centroids',
        # whose rows move or stay by the argmax of a few pixels
        "update_gap_median": statistics.median(leaf_gaps(prog["delta"], ref["delta"], keep)),
    }


class Program:
    """The port's train state with the seed's weights and its step call."""

    def __init__(self, cfg: dict, seed: int, dev):
        from depthg_tpu_torch.train import step as step_lib

        common.numerics()
        self.cfg, self.seed = cfg, seed
        self.hp, self.lcfg = hparams(cfg)
        sd = make_state_dict(cfg, common.stream_seed(seed, "weights"), dev, decoder=True)
        self.state = step_lib.state_from_model(common.segmenter(cfg, sd, decoder=True), self.hp)
        self.step_fn = step_lib.train_step
        self.gen = torch.Generator(device=dev)
        self.carry = torch.zeros((), device=dev)
        self.params = dict(self.state.model.named_parameters())

    def launch(self, i: int, batch: dict) -> torch.Tensor:
        tc = self.cfg["train"]
        self.gen.manual_seed(common.stream_seed(self.seed, "step", i))
        fed = {k: v + self.carry if v.is_floating_point() else v for k, v in batch.items()}
        logs = self.step_fn(self.state, fed, self.hp, self.lcfg, tc["depth_feat_weight"],
                            tc["depth_feat_shift"], generator=self.gen)
        self.carry = logs["loss/total"].float() * 0.0
        return logs["loss/total"]

    def first_steps(self, ring: list) -> dict:
        """CHECK_STEPS steps through ``launch``, read as `run_steps` returns."""
        start = {k: self.params[k].detach().clone() for k in train_ref.TRAINABLE}
        losses, grads = [], None
        for i in range(CHECK_STEPS):
            losses.append(self.launch(i, ring[i % len(ring)]))
            if i == 0:
                grads = {}
                for opt in self.state.opt.values():
                    beta1 = opt.param_groups[0]["betas"][0]
                    for p in opt.param_groups[0]["params"]:
                        name = next(k for k, v in self.params.items() if v is p)
                        grads[name] = opt.state[p]["exp_avg"].detach() / (1.0 - beta1)
        return {"losses": [float(v) for v in losses],
                "grads": {k: grads[k].clone() for k in train_ref.TRAINABLE},
                "delta": {k: self.params[k].detach() - start[k] for k in train_ref.TRAINABLE}}


def reference(cfg: dict, seed: int, ring: list, dev, quantize=None, batch_rows=None) -> dict:
    """The reference's first steps from the seed's weights, drawn again.
    ``batch_rows`` keeps only that many rows of each batch (a fault)."""
    sd = make_state_dict(cfg, common.stream_seed(seed, "weights"), dev, decoder=True)
    batches = [ring[i % len(ring)] for i in range(CHECK_STEPS)]
    if batch_rows is not None:
        batches = [{k: v[:batch_rows] for k, v in b.items()} for b in batches]
    seeds = [common.stream_seed(seed, "step", i) for i in range(CHECK_STEPS)]
    dtype = getattr(torch, cfg["train"]["backbone_dtype"])
    return train_ref.run_steps(sd, cfg, batches, seeds, dev, dtype, quantize)


def run(spec: dict, seed: int, seconds: float, trace: bool, dev, t_start: float) -> dict:
    cfg, tr, cell = spec["config"], spec["traffic"], spec["cell"]
    limits = json.loads((LIMITS / f"{cell['name']}.json").read_text())
    prog = Program(cfg, seed, dev)
    ring = make_ring(cfg, tr, seed, dev)
    first = prog.first_steps(ring)  # also the warm-up: the first builds the kernels
    common.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    last = []

    def launch(i):
        k = CHECK_STEPS + i
        last[:] = [prog.launch(k, ring[k % len(ring)])]

    n, window_s = common.window(launch, seconds, dev)
    peak = common.peak_bytes(dev)
    summary = None
    if trace:
        from benchmark import trace as trace_lib

        it = iter(range(n, n + tr["trace_steps"]))
        summary = trace_lib.profile(lambda: launch(next(it)), tr["trace_steps"], dev)
    finite = bool(torch.isfinite(last[0])) if last else True
    del prog, last
    common.free(dev)
    gaps = compare(first, reference(cfg, seed, ring, dev))
    batch = cfg["train"]["batch"]
    return {
        "metrics": {"train_step_ms": 1e3 * window_s / max(n, 1), "setup_s": setup_s},
        "attempted": n, "failed": 0 if finite else 1,
        "checks": {k: (v, limits[k]) for k, v in gaps.items()}
        | {"window_loss_not_finite": (0 if finite else 1, 0)},
        "memory_peak_bytes": peak, "trace": summary,
        "counts": {"steps": n, "window_s": window_s, "batch": batch,
                   "step_flops": counting.train_step_flops(cfg, batch)},
    }


def readings(spec: dict, seed: int, dev) -> dict:
    """The numbers `correct` compares: the program's first steps against the
    reference's, the control's (the reference with an fp8 backbone in the
    program's place) and the half-batch fault's (the reference on the first
    half of each batch). A state left unchanged reads an `update_gap_median` of 1
    and needs no run."""
    from benchmark.reference.control import fp8_round

    cfg, tr = spec["config"], spec["traffic"]
    prog = Program(cfg, seed, dev)
    ring = make_ring(cfg, tr, seed, dev)
    first = prog.first_steps(ring)
    del prog
    common.free(dev)
    ref = reference(cfg, seed, ring, dev)
    return {"program": compare(first, ref),
            "control": compare(reference(cfg, seed, ring, dev, quantize=fp8_round), ref),
            "faults": {"half_batch": compare(
                reference(cfg, seed, ring, dev, batch_rows=cfg["train"]["batch"] // 2), ref)}}
