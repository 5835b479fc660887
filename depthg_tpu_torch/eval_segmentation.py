"""Evaluate segmenter checkpoints with the PyTorch port.

Usage (the CLI surface of ``scripts/eval_segmentation.py``)::

    python -m depthg_tpu_torch.eval_segmentation [key=value | --key value] ...

Reads ``depthg_tpu_torch/configs/eval_config.yml`` with overrides (including
``operating_point=<name>``), loads each reference Lightning ``.ckpt`` in
``model_paths``, runs flip-TTA probes + the dense CRF over the val split on
``device`` (default ``cuda``; ``device=cpu`` runs the plain versions of the
kernels) and writes the Hungarian-matched metrics to
``<output_root>/eval_metrics.json``. Batches are staged through pinned host
memory with non-blocking copies. Left for later: orbax checkpoint
directories (they need JAX), the matplotlib figures and wandb logging;
``run_prediction`` writes color PNGs of the first batch and the confusion
matrices.
"""

from __future__ import annotations

import json
import os
import sys
import time
from os.path import join

import numpy as np
import torch

from depthg_tpu_torch.config import Config, cli_overrides, load_config
from depthg_tpu_torch.data import ContrastiveSegDataset, DataLoader, get_transform
from depthg_tpu_torch.data.datasets import create_cityscapes_colormap, \
    create_pascal_label_colormap
from depthg_tpu_torch.inference import Segmenter, ecfg_from_checkpoint, \
    fcfg_from_run_cfg, make_eval_step, make_predict_step, unnormalize_255
from depthg_tpu_torch.ops.crf import operating_point_overrides
from depthg_tpu_torch.runtime import get_device
from depthg_tpu_torch.utils.ckpt import load_lightning_ckpt
from depthg_tpu_torch.utils.metrics import SegMetrics


def _stage(batch: dict, device: torch.device):
    """Host batch -> device tensors via pinned memory (non-blocking)."""
    img = torch.from_numpy(np.ascontiguousarray(batch["img"], np.float32))
    label = torch.from_numpy(np.ascontiguousarray(batch["label"]))
    if device.type == "cuda":
        img, label = img.pin_memory(), label.pin_memory()
    return (img.to(device, non_blocking=True),
            label.to(device, non_blocking=True))


def evaluate_checkpoint(model_path: str, cfg: Config, device: torch.device) -> dict:
    if os.path.isdir(model_path):
        raise NotImplementedError(
            f"{model_path}: orbax checkpoint directories need JAX; the port "
            "loads Lightning .ckpt files (ROADMAP: orbax checkpoints)")
    sd, hparams = load_lightning_ckpt(model_path)
    run_cfg = Config(hparams or {})
    fcfg = fcfg_from_run_cfg(run_cfg)
    dataset_name = run_cfg.get("dataset_name", "cocostuff27")
    loader_crop = None if dataset_name == "voc" else "center"
    data_dir = cfg.data_dir
    if dataset_name == "nyuv2":
        data_dir = join(data_dir, "nyuv2")
    dataset = ContrastiveSegDataset(
        data_dir=data_dir, dataset_name=dataset_name, crop_type=None,
        image_set="val", transform=get_transform(cfg.res, False, loader_crop),
        target_transform=get_transform(cfg.res, True, loader_crop),
        cfg=run_cfg, mask=True)
    n_classes = dataset.n_classes
    extra_clusters = int(run_cfg.get("extra_clusters", 0))
    loader = DataLoader(dataset, cfg.batch_size * 2, shuffle=False,
                        num_workers=cfg.num_workers)

    ecfg = ecfg_from_checkpoint(cfg, sd, run_cfg, n_classes=n_classes,
                                extra_clusters=extra_clusters)
    model = Segmenter.from_state_dict(sd, fcfg).to(device)
    eval_step = make_eval_step(ecfg)
    linear_metrics = SegMetrics("final/linear/", n_classes, 0, False)
    cluster_metrics = SegMetrics("final/cluster/", n_classes, extra_clusters, True)

    t0 = time.time()
    n_images = 0
    pending = []
    for batch in loader:
        img, label = _stage(batch, device)
        pending.append(eval_step(model, img, label))
        n_images += img.shape[0]
        if len(pending) >= 8:  # fetch in groups, keeping the device queue full
            for ls, cs in pending:
                linear_metrics.add_stats(ls)
                cluster_metrics.add_stats(cs)
            pending.clear()
    for ls, cs in pending:
        linear_metrics.add_stats(ls)
        cluster_metrics.add_stats(cs)
    dt = time.time() - t0
    metrics = {**linear_metrics.compute(), **cluster_metrics.compute(),
               "images_per_sec_end_to_end": n_images / dt, "n_images": n_images,
               "device": str(device) if device.type == "cpu"
               else torch.cuda.get_device_name(device)}
    print(model_path)
    print(json.dumps(metrics, indent=2))

    if cfg.get("run_prediction", False):
        _write_predictions(cfg, loader, model, ecfg, device, dataset_name,
                           cluster_metrics, linear_metrics)
    return metrics


def _write_predictions(cfg, loader, model, ecfg, device, dataset_name,
                       cluster_metrics, linear_metrics):
    """Color PNGs of the first batch (image, label, matched clusters,
    linear) and the confusion matrices."""
    from PIL import Image

    result_dir = join(cfg.output_root, "predictions", cfg.experiment_name)
    for sub in ("img", "label", "cluster", "linear"):
        os.makedirs(join(result_dir, sub), exist_ok=True)
    cmap = (create_cityscapes_colormap() if dataset_name.startswith("cityscapes")
            else create_pascal_label_colormap())
    batch = next(iter(loader))
    img, _ = _stage(batch, device)
    lin, clu = (p.cpu().numpy() for p in make_predict_step(ecfg)(model, img))
    clu = cluster_metrics.map_clusters(clu)
    rgb = unnormalize_255(img).round().byte().permute(0, 2, 3, 1).cpu().numpy()
    for j in range(min(img.shape[0], int(cfg.get("n_images", 8)))):
        Image.fromarray(rgb[j]).save(join(result_dir, "img", f"{j}.jpg"))
        for sub, lab in (("label", np.maximum(batch["label"][j], 0)),
                         ("cluster", np.maximum(clu[j], 0)), ("linear", lin[j])):
            Image.fromarray(cmap[lab].astype(np.uint8)).save(
                join(result_dir, sub, f"{j}.png"))
    np.savez(join(result_dir, "confusion.npz"),
             cluster=cluster_metrics.stats, linear=linear_metrics.stats)


def eval_config(overrides) -> Config:
    """``eval_config.yml`` with ``k=v`` overrides. ``operating_point=<name>``
    expands ahead of the other overrides, so explicit crf_* keys still win."""
    point = [o.split("=", 1)[1] for o in overrides if o.startswith("operating_point=")]
    if point:
        overrides = (operating_point_overrides(point[-1])
                     + [o for o in overrides if not o.startswith("operating_point=")])
    return load_config("eval_config.yml", overrides)


def main(argv=None):
    cfg = eval_config(cli_overrides(argv if argv is not None else sys.argv[1:]))
    device = get_device(cfg.get("device", "cuda"))
    all_metrics = {p: evaluate_checkpoint(p, cfg, device) for p in cfg.model_paths}
    out_path = join(cfg.output_root, "eval_metrics.json")
    os.makedirs(cfg.output_root, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(all_metrics, f, indent=2)
    print(f"wrote {out_path}")
    return all_metrics


if __name__ == "__main__":
    main()
