"""Offline five-crop / random-crop dataset materialization
(``scripts/crop_datasets.py`` over the port's own ``data/``; numpy and PIL
only, nothing runs on a device).

    python -m depthg_tpu_torch.crop_datasets data_dir=... crop_datasets=[cocostuff27]

Mirrors reference ``src/crop_datasets.py``: reads each source dataset at full
resolution (tensorize-only transforms), produces 5 crops per image at
``crop_ratio`` (five-crop corners+center, or seeded random crops), and writes
``cropped/{ds}_{crop}_crop_{ratio}[_{depth}]/{img,label,depth}/{split}/`` with
``{i}.jpg``, ``{i}.png`` (label+1), ``{i}_{depth_type}.png`` (8-bit).

Determinism note: the reference derives random-crop offsets from python
``hash((seed, i, k))`` which varies across interpreter runs unless
PYTHONHASHSEED is pinned; here offsets come from ``zlib.crc32`` so the same
command always writes the same crops.
"""

import os
import sys
import zlib
from os.path import join

import numpy as np
from PIL import Image

from depthg_tpu_torch.config import cli_overrides, load_config
from depthg_tpu_torch.data import ContrastiveSegDataset
from depthg_tpu_torch.data.transforms import RawTransform


def five_crop_np(arr: np.ndarray, ch: int, cw: int):
    """[..., H, W] -> (tl, tr, bl, br, center), torchvision five_crop order."""
    h, w = arr.shape[-2], arr.shape[-1]
    tl = arr[..., :ch, :cw]
    tr = arr[..., :ch, w - cw:]
    bl = arr[..., h - ch:, :cw]
    br = arr[..., h - ch:, w - cw:]
    top = (h - ch) // 2
    left = (w - cw) // 2
    center = arr[..., top:top + ch, left:left + cw]
    return [tl, tr, bl, br, center]


def random_crops_np(arr: np.ndarray, ch: int, cw: int, seed: int, n: int = 5):
    h, w = arr.shape[-2], arr.shape[-1]
    out = []
    for i in range(n):
        top = zlib.crc32(f"{seed}:{i}:0".encode()) % (h - ch)
        left = zlib.crc32(f"{seed}:{i}:1".encode()) % (w - cw)
        out.append(arr[..., top:top + ch, left:left + cw])
    return out


def to_uint8_img(img_chw: np.ndarray) -> np.ndarray:
    return np.clip(img_chw * 255 + 0.5, 0, 255).astype(np.uint8).transpose(1, 2, 0)


def process_dataset(cfg, dataset_name, img_set, crop_type, crop_ratio, depth_type):
    # directory naming matches CroppedDataset's reader (data/datasets.py):
    # gt depth for nyuv2/potsdam and zoedepth for non-nyuv2 use the
    # suffix-less directory. (The reference writer suffixes potsdam-gt while
    # its own reader does not, src/crop_datasets.py:88-100 vs src/data.py:825-827
    # — aligned here so the repo's crop->train round trip works.)
    if depth_type == "gt" and dataset_name in ("nyuv2", "potsdam"):
        save_dir = join(cfg.data_dir, "cropped", f"{dataset_name}_{crop_type}_crop_{crop_ratio}")
    elif depth_type == "zoedepth" and dataset_name != "nyuv2":
        save_dir = join(cfg.data_dir, "cropped", f"{dataset_name}_{crop_type}_crop_{crop_ratio}")
    else:
        save_dir = join(cfg.data_dir, "cropped",
                        f"{dataset_name}_{crop_type}_crop_{crop_ratio}_{depth_type}")
    img_dir = join(save_dir, "img", img_set)
    label_dir = join(save_dir, "label", img_set)
    depth_dir = join(save_dir, "depth", img_set)
    for d in (img_dir, label_dir, depth_dir):
        os.makedirs(d, exist_ok=True)

    generate_depth = bool(cfg.get("generate_depth", False))
    dataset = ContrastiveSegDataset(
        cfg.data_dir, dataset_name, None, img_set,
        RawTransform(is_label=False), RawTransform(is_label=True), cfg=cfg,
        num_neighbors=cfg.num_neighbors, return_depth=generate_depth,
        depth_type=depth_type)

    rng = np.random.default_rng(0)
    for item in range(len(dataset)):
        batch = dataset.__getitem__(item, rng)
        img, label = batch["img"], batch["label"]
        ch, cw = int(img.shape[-2] * crop_ratio), int(img.shape[-1] * crop_ratio)
        if crop_type == "five":
            img_crops = five_crop_np(img, ch, cw)
            label_crops = five_crop_np(label, ch, cw)
            depth_crops = five_crop_np(batch["depth"], ch, cw) if generate_depth else None
        elif crop_type == "random":
            if generate_depth:
                raise NotImplementedError("Random crop with depth generation is not implemented")
            img_crops = random_crops_np(img, ch, cw, item)
            label_crops = random_crops_np(label, ch, cw, item)
            depth_crops = None
        else:
            raise ValueError(f"Unknown crop type {crop_type}")

        for crop_num in range(len(img_crops)):
            img_num = item * 5 + crop_num
            Image.fromarray(to_uint8_img(img_crops[crop_num])).save(
                join(img_dir, f"{img_num}.jpg"), "JPEG")
            Image.fromarray((label_crops[crop_num] + 1).astype(np.uint8)).save(
                join(label_dir, f"{img_num}.png"), "PNG")
            if depth_crops is not None:
                d = np.clip(depth_crops[crop_num][0] * 255 + 0.5, 0, 255).astype(np.uint8)
                Image.fromarray(d, mode="L").save(
                    join(depth_dir, f"{img_num}_{depth_type}.png"), "PNG")
        if (item + 1) % 200 == 0:
            print(f"  {item + 1}/{len(dataset)} images cropped")


def main(argv=None):
    overrides = cli_overrides(argv if argv is not None else sys.argv[1:])
    cfg = load_config("local_config.yml", overrides)

    dataset_names = list(cfg.get("crop_datasets", ["cocostuff27"]))
    img_sets = list(cfg.get("crop_image_sets", ["train", "val"]))
    crop_types = list(cfg.get("crop_types", ["five"]))
    crop_ratios = list(cfg.get("crop_ratios", [0.5]))
    depth_types = list(cfg.get("crop_depth_types", [cfg.get("depth_type", "zoedepth")]))

    for crop_ratio in crop_ratios:
        for crop_type in crop_types:
            for dataset_name in dataset_names:
                for depth_type in depth_types:
                    for img_set in img_sets:
                        print(f"cropping {dataset_name}/{img_set} {crop_type}@{crop_ratio} ({depth_type})")
                        process_dataset(cfg, dataset_name, img_set, crop_type,
                                        crop_ratio, depth_type)


if __name__ == "__main__":
    main()
