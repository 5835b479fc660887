"""Evaluate segmenter checkpoints with the PyTorch port.

Usage (the CLI surface of ``scripts/eval_segmentation.py``)::

    python -m depthg_tpu_torch.eval_segmentation [key=value | --key value] ...

Reads ``depthg_tpu_torch/configs/eval_config.yml`` with overrides (including
``operating_point=<name>``), loads each reference Lightning ``.ckpt`` in
``model_paths`` (a Lightning ``.ckpt``, the port trainer's ``<tag>.pt`` or
the JAX package's orbax directory), runs flip-TTA probes + the dense CRF
over the val split on ``device`` (default ``cuda``; ``device=cpu`` runs the
plain versions of the kernels) and writes the Hungarian-matched metrics to
``<output_root>/eval_metrics.json``. Batches are staged through pinned host
memory with non-blocking copies. ``run_prediction`` writes color PNGs of
the first batch, the confusion matrices (``confusion.npz``,
``confusion.png``) and the matplotlib figures ``prediction_grid.png`` and
``confusion_matrix.png`` (skipped for datasets without class names);
``wandb_logging=True`` logs the metrics and figures to wandb when it is
installed.

Data-parallel over N GPUs, one process each::

    torchrun --nproc_per_node N -m depthg_tpu_torch.eval_segmentation n_devices=N ...

Each rank takes its rows of every global batch (the tail batch is padded
only to divide over the ranks, with labels -1 that the confusion blocks
ignore), the blocks are all-reduced, and rank 0 writes the metrics and
the figures.
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
from depthg_tpu_torch.parallel import dist
from depthg_tpu_torch.runtime import get_device, to_device
from depthg_tpu_torch.utils.checkpoint_io import load_segmenter
from depthg_tpu_torch.utils.metrics import SegMetrics


def _maybe_wandb(cfg: Config):
    """Optional wandb run, gated exactly like the train CLI (reference eval
    logs metrics + plots to wandb, ``src/eval_segmentation.py:190-247``)."""
    if not cfg.get("wandb_logging"):
        return None
    try:
        import wandb
    except ImportError:
        print("wandb_logging=True but wandb is not installed; json logs only")
        return None
    wandb.init(project="depthg-torch", name=f"eval-{cfg.experiment_name}",
               config=dict(cfg), job_type="eval")
    return wandb


def _stage(batch: dict, device: torch.device):
    """This rank's rows of a global batch (as the loader gives them) ->
    device tensors via pinned memory (non-blocking), and the global batch's
    count of real images."""
    return (to_device(np.asarray(batch["img"], np.float32), device),
            to_device(np.asarray(batch["label"]), device), batch["n_real"])


def _group():
    return torch.distributed.group.WORLD if dist.active() else None


def evaluate_checkpoint(model_path: str, cfg: Config, device: torch.device,
                        wandb=None) -> dict:
    sd, run_cfg = load_segmenter(model_path)
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
    model = Segmenter.from_state_dict(sd, fcfg, ecfg.backbone_dtype).to(device)
    eval_step = make_eval_step(ecfg, _group())
    linear_metrics = SegMetrics("final/linear/", n_classes, 0, False)
    cluster_metrics = SegMetrics("final/cluster/", n_classes, extra_clusters, True)

    t0 = time.time()
    n_images = 0
    pending = []
    for batch in loader:
        img, label, n_real = _stage(batch, device)
        pending.append(eval_step(model, img, label))
        n_images += n_real
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
    if dist.is_main():
        print(model_path)
        print(json.dumps(metrics, indent=2))
    if wandb is not None:
        wandb.log({k: v for k, v in metrics.items() if isinstance(v, (int, float))})

    if cfg.get("run_prediction", False):
        _write_predictions(cfg, loader, model, ecfg, device, dataset_name,
                           cluster_metrics, linear_metrics, extra_clusters, wandb)
    return metrics


def _write_predictions(cfg, loader, model, ecfg, device, dataset_name,
                       cluster_metrics, linear_metrics, extra_clusters, wandb=None):
    """Color PNGs of the first batch (image, label, matched clusters,
    linear), the confusion matrices and the figures; every rank predicts
    its rows, rank 0 writes."""
    from PIL import Image

    from depthg_tpu_torch.utils.figures import confusion_matrix_figure, prediction_grid
    from depthg_tpu_torch.utils.metrics import confusion_heatmap_png

    batch = next(iter(loader))
    img, label, n_real = _stage(batch, device)
    lin, clu = (p.cpu().numpy()[:n_real]
                for p in make_predict_step(ecfg, _group())(model, img))
    # every rank holds its rows of the batch: rank 0 shows them all
    img, label = (dist.all_gather(t)[:n_real].cpu() for t in (img, label))
    if not dist.is_main():
        return
    result_dir = join(cfg.output_root, "predictions", cfg.experiment_name)
    for sub in ("img", "label", "cluster", "linear"):
        os.makedirs(join(result_dir, sub), exist_ok=True)
    cmap = (create_cityscapes_colormap() if dataset_name.startswith("cityscapes")
            else create_pascal_label_colormap())
    clu = cluster_metrics.map_clusters(clu)
    rgb = unnormalize_255(img).round().byte().permute(0, 2, 3, 1).numpy()
    label = label.numpy()
    rgbs, label_rgb, clu_rgb, lin_rgb = [], [], [], []
    for j in range(min(n_real, int(cfg.get("n_images", 8)))):
        rgbs.append(rgb[j])
        label_rgb.append(cmap[np.maximum(label[j], 0)].astype(np.uint8))
        clu_rgb.append(cmap[np.maximum(clu[j], 0)].astype(np.uint8))
        lin_rgb.append(cmap[lin[j]].astype(np.uint8))
        Image.fromarray(rgb[j]).save(join(result_dir, "img", f"{j}.jpg"))
        for sub, colors in (("label", label_rgb), ("cluster", clu_rgb), ("linear", lin_rgb)):
            Image.fromarray(colors[-1]).save(join(result_dir, sub, f"{j}.png"))
    np.savez(join(result_dir, "confusion.npz"),
             cluster=cluster_metrics.stats, linear=linear_metrics.stats)
    confusion_heatmap_png(cluster_metrics.stats, join(result_dir, "confusion.png"))
    # reference-style matplotlib figures (scripts/eval_segmentation.py:199-210)
    prediction_grid(rgbs, label_rgb, clu_rgb, lin_rgb, cmap,
                    join(result_dir, "prediction_grid.png"),
                    dark_mode=bool(cfg.get("dark_mode", False)))
    try:
        confusion_matrix_figure(cluster_metrics.stats, dataset_name, cmap,
                                join(result_dir, "confusion_matrix.png"), extra_clusters)
    except ValueError:
        pass  # datasets without a reference class-name list
    if wandb is not None:  # the reference's wandb.Image plot uploads
        wandb.log({"predictions": wandb.Image(join(result_dir, "prediction_grid.png")),
                   "confusion": wandb.Image(join(result_dir, "confusion.png"))})


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
    dist.init_from_env(device=device.type)
    dist.check_world(cfg.get("n_devices"))
    device = dist.rank_device(device)
    wandb = _maybe_wandb(cfg) if dist.is_main() else None
    all_metrics = {p: evaluate_checkpoint(p, cfg, device, wandb) for p in cfg.model_paths}
    if not dist.is_main():
        return all_metrics
    out_path = join(cfg.output_root, "eval_metrics.json")
    os.makedirs(cfg.output_root, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(all_metrics, f, indent=2)
    print(f"wrote {out_path}")
    return all_metrics


if __name__ == "__main__":
    main()
