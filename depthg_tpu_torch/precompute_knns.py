"""Precompute dataset-wide image-level KNNs (``scripts/precompute_knns.py``).

    python -m depthg_tpu_torch.precompute_knns data_dir=... pretrained_weights=dino.pth

Mirrors reference ``src/precompute_knns.py``: for each (crop_type, image_set,
dataset), embed every image with the frozen backbone (mean-pooled,
normalized), compute the top-30 cosine neighbors and write
``nns/nns_{model_type}_{name}_{image_set}_{crop_type}_{res}.npz`` in the
same format (an int32 ``nns`` array [N, 30]), which the trainer reads. Reads
``depthg_tpu_torch/configs/local_config.yml`` with overrides and runs on
``device`` (default ``cuda``; it raises when there is no card). The backbone
runs in float32, as in the JAX script; the last batch runs at its own size.
A ViT ``model_type`` embeds with DINO weights from ``pretrained_weights``;
the CNN types of ``models.pyramid.load_model`` (``resnet50``,
``robust_resnet50``, ``mocov2``, ``densecl``, ``densenet121``, ``vgg11``)
with their file from ``{output_root}/data``, mean-pooled over H and W
(C = 2048 / 1024 / 512, batch 64). Without weights the backbone is random
(seed 0), with a warning.

Data-parallel over N GPUs, one process each::

    torchrun --nproc_per_node N -m depthg_tpu_torch.precompute_knns n_devices=N ...

Each rank embeds its rows of every batch (the last one padded to divide
over the ranks) and the features are all-gathered; the top-k splits its
query rows over the ranks (``parallel.knn.topk_neighbors(group=)``);
rank 0 writes the ``nns`` files, equal to a single process's.
"""

from __future__ import annotations

import os
import sys
from os.path import join

import numpy as np
import torch

from depthg_tpu_torch.config import cli_overrides, load_config
from depthg_tpu_torch.data import ContrastiveSegDataset, DataLoader, get_transform
from depthg_tpu_torch.inference import fcfg_from_run_cfg
from depthg_tpu_torch.models.featurizer import DinoFeaturizer
from depthg_tpu_torch.models.pyramid import backbone_for, load_model
from depthg_tpu_torch.models.vit import VIT_PRESETS
from depthg_tpu_torch.parallel import dist
from depthg_tpu_torch.parallel import knn as knn_lib
from depthg_tpu_torch.runtime import get_device, to_device
from depthg_tpu_torch.utils.ckpt import load_dino_pth


def embed_dataset(dataset, net, batch_size, num_workers, precision=None,
                  device: str | torch.device = "cuda") -> np.ndarray:
    """[N, C] float32 pooled, normalized embeddings of every image of
    ``dataset``, in its order. Under a process group each rank loads and
    embeds only its rows of each batch and every rank returns them all."""
    dev = get_device(device)
    net = net.to(dev)
    feats = []
    loader = DataLoader(dataset, batch_size, shuffle=False, num_workers=num_workers,
                        drop_last=False)
    n_done = 0
    for batch in loader:
        n_real = batch["n_real"]
        img = to_device(np.asarray(batch["img"], np.float32), dev)
        feats.append(dist.all_gather(knn_lib.pooled_features(net, img, precision))[:n_real])
        n_done += n_real
        if dist.is_main() and n_done % (batch_size * 20) == 0:
            print(f"  embedded {n_done}/{len(dataset)}")
    return torch.cat(feats).cpu().numpy()


def main(argv=None):
    overrides = cli_overrides(argv if argv is not None else sys.argv[1:])
    cfg = load_config("local_config.yml", overrides)
    device = get_device(cfg.get("device", "cuda"))
    dist.init_from_env(device=device.type)
    dist.check_world(cfg.get("n_devices"))
    device = dist.rank_device(device)
    group = torch.distributed.group.WORLD if dist.active() else None

    data_dir = cfg.data_dir
    if dist.is_main():
        os.makedirs(join(data_dir, "nns"), exist_ok=True)

    image_sets = list(cfg.get("knn_image_sets", ["train", "val"]))
    dataset_names = list(cfg.get("knn_datasets", ["cocostuff27", "cityscapes", "potsdam"]))
    crop_types = list(cfg.get("knn_crop_types", ["five", None]))
    # the reference hardcodes 392 here while training looks the file up under
    # cfg.res (src/precompute_knns.py:50 vs src/data.py:1056) — defaulting to
    # cfg.res keeps the pipeline coherent out of the box; override via knn_res.
    res = int(cfg.get("knn_res", cfg.res))
    batch_size = 128 if cfg.model_type == "vit_small" else 64

    if cfg.model_type not in VIT_PRESETS:
        # the reference's cut_model path (src/precompute_knns.py:60-64);
        # an unknown type raises ValueError here
        try:
            net, _ = load_model(cfg.model_type, join(cfg.output_root, "data"))
        except FileNotFoundError as e:
            print(f"WARNING: {e}; using random backbone weights — neighbor "
                  "quality will be meaningless.")
            net, _ = backbone_for(cfg.model_type)
            net.init_weights(torch.Generator().manual_seed(0))
    else:
        net = DinoFeaturizer(fcfg_from_run_cfg(cfg))
        if cfg.get("pretrained_weights"):
            net.model.load_state_dict(load_dino_pth(cfg.pretrained_weights), strict=True)
        else:
            print("WARNING: no pretrained_weights given; using random backbone "
                  "weights — neighbor quality will be meaningless.")
            net.model.init_weights(torch.Generator().manual_seed(0))
    net = net.to(device).eval()

    written = []
    for crop_type in crop_types:
        for image_set in image_sets:
            for dataset_name in dataset_names:
                nice_name = cfg.dir_dataset_name if dataset_name == "directory" else dataset_name
                cache = join(data_dir, "nns",
                             f"nns_{cfg.model_type}_{nice_name}_{image_set}_{crop_type}_{res}.npz")
                if os.path.exists(cache):
                    print(f"Found {cache}")
                    continue
                print(f"{cache} not found, computing")
                try:
                    dataset = ContrastiveSegDataset(
                        data_dir=data_dir, dataset_name=dataset_name,
                        crop_type=crop_type, image_set=image_set,
                        transform=get_transform(res, False, "center"),
                        target_transform=get_transform(res, True, "center"),
                        cfg=cfg)
                except (FileNotFoundError, OSError) as e:
                    print(f"  skipping (data not present): {e}")
                    continue
                feats = embed_dataset(dataset, net, batch_size, cfg.num_workers,
                                      cfg.get("matmul_precision"), device)
                nns = knn_lib.topk_neighbors(feats, k=30, group=group, device=device)
                if dist.is_main():
                    np.savez_compressed(cache, nns=nns)
                    print(f"Saved NNs -> {cache} ({nns.shape})")
                dist.barrier()  # every rank sees the file before its next check
                written.append(cache)
    return written


if __name__ == "__main__":
    main()
