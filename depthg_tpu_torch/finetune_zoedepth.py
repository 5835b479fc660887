"""Fine-tune ZoeDepth on a metric-depth dataset, on one GPU.

    python -m depthg_tpu_torch.finetune_zoedepth dataset=nyu data_root=/data \\
        filenames_file=train.txt filenames_file_eval=test.txt epochs=5 [device=cuda|cpu]

The port of ``scripts/finetune_zoedepth.py``, with its ``k=v`` (or
``--k v``) overrides of ``DEFAULTS``: the epoch loop over
``DataLoadPreprocess`` samples in a ``numpy`` permutation per epoch
(``seed``), ``models/zoedepth/finetune.finetune_step`` (SILog [+ GradL1],
global-norm clip, four-group AdamW on one-cycle schedules), validation
every ``validate_every`` of an epoch and at the end (the reference's nine
metrics with its eigen/garg crops, SILog), and a best-on-``abs_rel``
monitor.

* The training forward runs BEiT's eager attention (the kernel has no
  backward); ``validate`` runs under ``torch.no_grad()`` with
  ``attn_impl="auto"``, so on the card each image goes through the
  attention kernel with BEiT's bias (24 launches per image).
* Model: ``tiny_model=true`` (a small random ``ZoeConfig``, for tests),
  ``checkpoint=<file.pt>`` (a released-layout ZoeDepth file, e.g.
  ``ZoeD_M12_N.pt``, through ``convert.load_zoedepth_pt``), or full-width
  random weights (``seed``); min and max depth from the dataset's spec.
  ``checkpoint=`` also takes the JAX package's ZoeDepth param tree, as an
  orbax directory (its fine-tune's checkpoints) or a ``.npz`` of dotted key
  paths (``convert.load_zoedepth_tree``; the orbax reader needs
  tensorstore).
* ``output_dir``: ``latest.pt`` (before each validation and at the end)
  and ``best.pt`` in the released layout, ``{"model": state_dict, "cfg",
  "step", "metrics"}``, which ``load_zoedepth_pt`` reads back (the JAX
  script writes orbax directories); ``finetune_log.jsonl`` with each
  logged step's ``ms`` on the host clock.
* ``eval_dataset=<name> eval_data_root=<dir>``: validate on one of
  ``models/zoedepth/eval_datasets.EVAL_READERS`` instead.
* ``device`` defaults to ``cuda`` and raises without a card; the CPU runs
  only when asked for.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from depthg_tpu_torch.config import Config, apply_overrides, cli_overrides
from depthg_tpu_torch.models.zoedepth import finetune
from depthg_tpu_torch.models.zoedepth.config import DEPTH_DATASETS
from depthg_tpu_torch.models.zoedepth.model import ZoeConfig, ZoeDepth
from depthg_tpu_torch.runtime import get_device, to_device

DEFAULTS = {
    # data
    "dataset": "nyu",
    "data_root": None,           # DEPTH_DATASETS root override
    "data_path": None, "gt_path": None,
    "data_path_eval": None, "gt_path_eval": None,
    "filenames_file": "", "filenames_file_eval": "",
    "batch_size": 16,
    "aug": True, "random_crop": False, "random_translate": False,
    "seed": 0,
    # schedule (reference config_zoedepth.json train block)
    "epochs": 5, "lr": 0.000161, "wd": 0.01, "w_si": 1.0, "w_grad": 0.0,
    "clip_grad": 0.1, "same_lr": False,
    "validate_every": 0.25,      # fraction of an epoch
    "log_every": 50,
    # model
    "checkpoint": None,          # a released-layout .pt, orbax directory or .npz
    "tiny_model": False,         # tests: small random ZoeConfig
    "output_dir": "./checkpoints_zoe",
    "max_steps": 0,              # 0 = no cap (tests cap it)
    "eval_limit": 0,             # 0 = whole eval set
    # validate against a specialized eval reader instead of
    # filenames_file_eval: any of models/zoedepth/eval_datasets.EVAL_READERS
    "eval_dataset": None, "eval_data_root": None,
    "device": "cuda",
}


def tiny_config() -> ZoeConfig:
    """The small random model of the tests (the JAX script's ``tiny_model``)."""
    from depthg_tpu_torch.models.zoedepth.beit import BEiTConfig
    from depthg_tpu_torch.models.zoedepth.dpt import DPTConfig

    return ZoeConfig(
        n_bins=4, bin_embedding_dim=8, n_attractors=(2, 2, 1, 1), img_size=(64, 96),
        beit=BEiTConfig(embed_dim=64, depth=4, num_heads=4, pretrain_window=4,
                        hooks=(0, 1, 2, 3)),
        dpt=DPTConfig(embed_dim=64, features=16, reassemble_channels=(8, 16, 32, 32)))


def build_model(cfg, device: torch.device) -> ZoeDepth:
    """The model to fine-tune, float32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(cfg["seed"]))
    if cfg["tiny_model"]:
        with device:
            return ZoeDepth(tiny_config()).init_weights(gen)
    spec = DEPTH_DATASETS[cfg["dataset"]]
    if cfg["checkpoint"]:
        path = str(cfg["checkpoint"])
        if os.path.isdir(path) or path.endswith(".npz"):
            from depthg_tpu_torch.models.zoedepth.convert import load_zoedepth_tree

            model = load_zoedepth_tree(path)
        else:
            from depthg_tpu_torch.models.zoedepth.convert import load_zoedepth_pt

            model = load_zoedepth_pt(path)
        model.cfg = dataclasses.replace(model.cfg, min_depth=spec.min_depth,
                                        max_depth=spec.max_depth)
        return model.to(device)
    with device:
        return ZoeDepth(ZoeConfig(min_depth=spec.min_depth, max_depth=spec.max_depth)
                        ).init_weights(gen)


def build_data(cfg):
    from depthg_tpu_torch.models.zoedepth.data_mono import DataLoadPreprocess, MonoDepthDataConfig

    over = {k: cfg[k] for k in ("data_path", "gt_path", "data_path_eval",
                                "gt_path_eval") if cfg[k]}
    dcfg = MonoDepthDataConfig.for_dataset(
        cfg["dataset"], cfg["data_root"],
        filenames_file=cfg["filenames_file"],
        filenames_file_eval=cfg["filenames_file_eval"],
        aug=bool(cfg["aug"]), random_crop=bool(cfg["random_crop"]),
        random_translate=bool(cfg["random_translate"]),
        seed=int(cfg["seed"]), **over)
    train = DataLoadPreprocess(dcfg, "train")
    test = (DataLoadPreprocess(dcfg, "online_eval")
            if cfg["filenames_file_eval"] else None)
    return dcfg, train, test


@torch.no_grad()
def validate(model: ZoeDepth, dcfg, test_set, spec, limit: int = 0):
    """The reference's ``validate_on_batch``: each image alone at its own
    resolution (``attn_impl="auto"``: the kernel on the card), SILog on the
    valid pixels, the nine crop-masked metrics averaged per image. Returns
    (metrics, losses)."""
    from depthg_tpu_torch.models.zoedepth.metrics import RunningAverageDict, compute_metrics

    device = next(model.parameters()).device
    metrics_avg, losses_avg = RunningAverageDict(), RunningAverageDict()
    n = len(test_set) if not limit else min(limit, len(test_set))
    for i in range(n):
        s = test_set[i]
        # DataLoadPreprocess marks missing depths; the eval readers always carry one
        if not s.get("has_valid_depth", "depth" in s):
            continue
        if "mask" not in s:
            # readers emit raw depth; validity = the dataset's open bounds
            s = dict(s, mask=(s["depth"] > spec.min_depth) & (s["depth"] < spec.max_depth))
        img = torch.from_numpy(np.ascontiguousarray(s["image"][None])).to(device)
        pred = model(img, attn_impl="auto")["metric_depth"]
        l_si = float(finetune.silog_loss(pred, torch.from_numpy(s["depth"][None]).to(device),
                                         torch.from_numpy(s["mask"][None]).to(device)))
        losses_avg.update({"silog": l_si})
        metrics_avg.update(compute_metrics(
            s["depth"][0], pred[0, 0].cpu().numpy(),
            garg_crop=spec.crop == "garg", eigen_crop=spec.crop == "eigen",
            dataset=dcfg.dataset, min_depth_eval=spec.min_depth_eval,
            max_depth_eval=spec.max_depth_eval))
    return metrics_avg.get_value(), losses_avg.get_value()


def main(argv=None) -> dict:
    cfg = apply_overrides(Config(DEFAULTS), cli_overrides(sys.argv[1:] if argv is None else argv))
    device = get_device(cfg["device"])

    from depthg_tpu_torch.models.zoedepth.data_mono import batched

    model = build_model(cfg, device)
    dcfg, train_set, test_set = build_data(cfg)
    spec = DEPTH_DATASETS[cfg["dataset"]]
    if cfg["eval_dataset"]:
        from depthg_tpu_torch.models.zoedepth.eval_datasets import get_eval_reader

        test_set = get_eval_reader(cfg["eval_dataset"], cfg["eval_data_root"])
        spec = DEPTH_DATASETS[cfg["eval_dataset"]]

    steps_per_epoch = max(len(train_set) // int(cfg["batch_size"]), 1)
    total = int(cfg["epochs"]) * steps_per_epoch
    if cfg["max_steps"]:
        total = min(total, int(cfg["max_steps"]))
    ftcfg = finetune.FinetuneConfig(
        lr=float(cfg["lr"]), wd=float(cfg["wd"]), w_si=float(cfg["w_si"]),
        w_grad=float(cfg["w_grad"]), clip_grad=float(cfg["clip_grad"]),
        same_lr=bool(cfg["same_lr"]), total_steps=total)
    state = finetune.init_state(model, ftcfg)

    validate_every = max(int(float(cfg["validate_every"]) * steps_per_epoch), 1)
    os.makedirs(cfg["output_dir"], exist_ok=True)
    best, best_metrics = np.inf, None
    rng = np.random.default_rng(int(cfg["seed"]))
    log_path = os.path.join(cfg["output_dir"], "finetune_log.jsonl")
    logs, final = {}, None

    def save(name, metrics=None):
        path = os.path.join(cfg["output_dir"], name)
        torch.save({"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                    "cfg": dict(cfg), "step": state.step, "metrics": metrics or {}}, path)
        return path

    def log(rec):
        print(json.dumps(rec), flush=True)
        log_f.write(json.dumps(rec) + "\n")
        log_f.flush()

    with open(log_path, "a") as log_f:
        for epoch in range(int(cfg["epochs"])):
            order = rng.permutation(len(train_set))
            for batch in batched(train_set, int(cfg["batch_size"]), order):
                t0 = time.perf_counter()
                device_batch = {k: to_device(batch[k], device) for k in ("image", "depth", "mask")}
                logs = finetune.finetune_step(state, device_batch)
                if state.step % int(cfg["log_every"]) == 0 or state.step == 1:
                    vals = {k: float(v) for k, v in logs.items()}
                    log({"step": state.step, "epoch": epoch,
                         "ms": round((time.perf_counter() - t0) * 1e3, 1), **vals})
                if test_set is not None and state.step % validate_every == 0:
                    save("latest.pt")
                    metrics, vlosses = validate(model, dcfg, test_set, spec,
                                                int(cfg["eval_limit"]))
                    log({"step": state.step, "val": metrics, "val_losses": vlosses})
                    crit = metrics.get("abs_rel", np.inf)
                    if crit < best:
                        best, best_metrics = crit, metrics
                        save("best.pt", metrics)
                if cfg["max_steps"] and state.step >= int(cfg["max_steps"]):
                    break
            if cfg["max_steps"] and state.step >= int(cfg["max_steps"]):
                break

        save("latest.pt")
        if test_set is not None:
            final, vlosses = validate(model, dcfg, test_set, spec, int(cfg["eval_limit"]))
            print(json.dumps({"final": final, "val_losses": vlosses}), flush=True)
            log_f.write(json.dumps({"step": state.step, "final": final}) + "\n")
    return {"output_dir": cfg["output_dir"], "log_path": log_path, "step": state.step,
            "final": final, "best": best_metrics,
            "last_logs": {k: float(v) for k, v in logs.items()}}


if __name__ == "__main__":
    main()
