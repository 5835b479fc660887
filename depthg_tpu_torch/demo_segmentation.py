"""Run a trained segmenter over a folder of unlabeled images
(``scripts/demo_segmentation.py``).

    python -m depthg_tpu_torch.demo_segmentation model_path=run.ckpt image_dir=./imgs

Mirrors reference ``src/demo_segmentation.py``: center-crop transform at
``res``, flip-TTA probes, per-image dense CRF, raw label-index PNGs saved to
``{output_root}/predictions/{experiment_name}/{linear,cluster}/``. Reads
``depthg_tpu_torch/configs/demo_config.yml`` with overrides and runs on
``device`` (default ``cuda``; it raises when there is no card). Batches hold
``batch_size * 2`` images; the last one runs at its own size (nothing is
compiled per shape, so it is not padded to the full batch).

Data-parallel over N GPUs, one process each::

    torchrun --nproc_per_node N -m depthg_tpu_torch.demo_segmentation n_devices=N ...

Each rank loads and predicts only its rows of every batch (the last one
padded to divide over the ranks), the label maps are gathered, and rank 0
writes the PNGs.
"""

from __future__ import annotations

import os
import sys
from os.path import join

import numpy as np
import torch
from PIL import Image

from depthg_tpu_torch.config import cli_overrides, load_config
from depthg_tpu_torch.data import DataLoader, get_transform
from depthg_tpu_torch.inference import Segmenter, ecfg_from_checkpoint, \
    fcfg_from_run_cfg, make_predict_step
from depthg_tpu_torch.parallel import dist
from depthg_tpu_torch.runtime import get_device, to_device
from depthg_tpu_torch.utils.checkpoint_io import load_segmenter


class UnlabeledImageFolder:
    def __init__(self, root, transform):
        self.root = root
        self.transform = transform
        self.images = sorted(os.listdir(root))

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        img = Image.open(join(self.root, self.images[index])).convert("RGB")
        return self.transform(img), self.images[index]


class _Items:
    """``UnlabeledImageFolder``'s items as the dicts ``DataLoader`` collates."""

    def __init__(self, folder):
        self.folder = folder

    def __len__(self):
        return len(self.folder)

    def __getitem__(self, index, rng=None):
        img, name = self.folder[index]
        return {"img": img, "name": name}


def main(argv=None):
    overrides = cli_overrides(argv if argv is not None else sys.argv[1:])
    cfg = load_config("demo_config.yml", overrides)
    device = get_device(cfg.get("device", "cuda"))
    dist.init_from_env(device=device.type)
    dist.check_world(cfg.get("n_devices"))
    device = dist.rank_device(device)

    result_dir = join(cfg.output_root, "predictions", cfg.experiment_name)
    if dist.is_main():
        os.makedirs(join(result_dir, "cluster"), exist_ok=True)
        os.makedirs(join(result_dir, "linear"), exist_ok=True)

    sd, run_cfg = load_segmenter(cfg.model_path)
    ecfg = ecfg_from_checkpoint(cfg, sd, run_cfg)
    model = Segmenter.from_state_dict(sd, fcfg_from_run_cfg(run_cfg),
                                     ecfg.backbone_dtype).to(device)
    predict = make_predict_step(
        ecfg, torch.distributed.group.WORLD if dist.active() else None)
    bs = int(cfg.batch_size) * 2

    dataset = UnlabeledImageFolder(cfg.image_dir, get_transform(cfg.res, False, "center"))
    loader = DataLoader(_Items(dataset), bs, shuffle=False, num_workers=cfg.num_workers)
    for b, batch in enumerate(loader):
        start = b * bs
        names = dataset.images[start:start + batch["n_real"]]
        imgs = np.asarray(batch["img"], np.float32)  # this rank's rows only
        lin, clu = (p.cpu().numpy() for p in predict(model, to_device(imgs, device)))
        if not dist.is_main():
            continue
        for j, name in enumerate(names):
            new_name = ".".join(name.split(".")[:-1]) + ".png"
            Image.fromarray(lin[j].astype(np.uint8)).save(join(result_dir, "linear", new_name))
            Image.fromarray(clu[j].astype(np.uint8)).save(join(result_dir, "cluster", new_name))
        print(f"processed {min(start + bs, len(dataset))}/{len(dataset)}")
    return result_dir


if __name__ == "__main__":
    main()
