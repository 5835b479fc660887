"""ContrastiveSegDataset: KNN-positive pairing over any base dataset.

Reference behavior (``src/data.py:931-1141``):
* per dataset name + crop_type, picks the base dataset class and n_classes;
* loads ``nns_{model}_{ds}_{set}_{crop}_{res}.npz`` (precompute_knns output)
  and asserts its length;
* each item draws a random neighbor of rank 1..num_neighbors as the positive;
* builds a [-1, 1] coordinate grid; optional photometric+geometric aug pair
  (``img_aug`` + the identically-transformed ``coord_aug``).
"""

from __future__ import annotations

import os
import warnings
from os.path import join

import numpy as np

from depthg_tpu_torch.data import datasets as D
from depthg_tpu_torch.data import transforms as T


def resolve_dataset(data_dir, dataset_name, crop_type, image_set, transform,
                    target_transform, cfg, return_depth=False, depth_type="zoedepth"):
    """Dataset-class dispatch table (reference ``src/data.py:962-1039``)."""
    if dataset_name == "potsdam":
        return 3, D.Potsdam(data_dir, image_set, transform, target_transform,
                            coarse_labels=True, return_depth=return_depth,
                            depth_type=depth_type)
    if dataset_name == "potsdamraw":
        warnings.warn("Depth cannot be used with potsdamraw; ignoring depth.")
        return 3, D.PotsdamRaw(data_dir, image_set, transform, target_transform,
                               coarse_labels=True)
    if dataset_name == "directory":
        return cfg.dir_dataset_n_classes, D.DirectoryDataset(
            data_dir, image_set, transform, target_transform, path=cfg.dir_dataset_name)
    if dataset_name == "cityscapes":
        if crop_type is None:
            return 27, D.CityscapesSeg(data_dir, image_set, transform, target_transform,
                                       return_depth=return_depth)
        return 27, D.CroppedDataset(data_dir, "cityscapes", crop_type, cfg.crop_ratio,
                                    image_set, transform, target_transform,
                                    return_depth=return_depth, depth_type=depth_type)
    if dataset_name == "cocostuff3":
        return 3, D.Coco(data_dir, image_set, transform, target_transform,
                         coarse_labels=True, subset=6, exclude_things=True)
    if dataset_name == "cocostuff15":
        return 15, D.Coco(data_dir, image_set, transform, target_transform,
                          coarse_labels=False, subset=7, exclude_things=True)
    if dataset_name == "cocostuff27":
        if crop_type is not None:
            return 27, D.CroppedDataset(data_dir, "cocostuff27", crop_type, cfg.crop_ratio,
                                        image_set, transform, target_transform,
                                        return_depth=return_depth, depth_type=depth_type)
        subset = 7 if image_set == "val" else None
        return 27, D.Coco(data_dir, image_set, transform, target_transform,
                          coarse_labels=False, subset=subset, exclude_things=False,
                          return_depth=return_depth, depth_type=depth_type)
    if dataset_name == "nyuv2":
        if crop_type is not None:
            return 14, D.CroppedDataset(data_dir, "nyuv2", crop_type, cfg.crop_ratio,
                                        image_set, transform, target_transform,
                                        return_depth=return_depth, depth_type=depth_type)
        return 14, D.NYUv2(data_dir, image_set, transform, target_transform,
                           return_depth=return_depth, depth_type=depth_type)
    if dataset_name == "pascalvoc":
        if crop_type is not None:
            return 21, D.CroppedDataset(data_dir, "pascalvoc", crop_type, cfg.crop_ratio,
                                        image_set, transform, target_transform,
                                        return_depth=return_depth, depth_type=depth_type)
        return 21, D.PascalVOC(data_dir, image_set, transform, target_transform,
                               return_depth=return_depth, depth_type=depth_type)
    raise ValueError(f"Unknown dataset: {dataset_name}")


class ContrastiveSegDataset:
    def __init__(self, data_dir, dataset_name, crop_type, image_set, transform,
                 target_transform, cfg, aug_geometric_transform=None,
                 aug_photometric_transform=None, num_neighbors=5,
                 compute_knns=False, mask=False, pos_labels=False, pos_images=False,
                 extra_transform=None, model_type_override=None,
                 return_depth=False, depth_type="zoedepth"):
        self.num_neighbors = num_neighbors
        self.image_set = image_set
        self.dataset_name = dataset_name
        if cfg is not None and cfg.get("image_cache_mb") is not None:
            # decoded-image LRU budget (datasets.IMAGE_CACHE); single-core
            # hosts re-decode every epoch without it
            from depthg_tpu_torch.data.datasets import IMAGE_CACHE

            IMAGE_CACHE.configure(int(cfg.get("image_cache_mb")))
        self.mask = mask
        self.pos_labels = pos_labels
        self.pos_images = pos_images
        self.extra_transform = extra_transform
        self.return_depth = return_depth
        self.aug_geometric_transform = aug_geometric_transform
        self.aug_photometric_transform = aug_photometric_transform

        self.n_classes, self.dataset = resolve_dataset(
            data_dir, dataset_name, crop_type, image_set, transform,
            target_transform, cfg, return_depth, depth_type)

        if pos_labels or pos_images:
            model_type = model_type_override or cfg.model_type
            nice_name = cfg.dir_dataset_name if dataset_name == "directory" else dataset_name
            feature_cache_file = join(
                data_dir, "nns",
                f"nns_{model_type}_{nice_name}_{image_set}_{crop_type}_{cfg.res}.npz")
            if not os.path.exists(feature_cache_file) or compute_knns:
                raise ValueError(
                    f"could not find nn file {feature_cache_file} please run precompute_knns")
            self.nns = np.load(feature_cache_file)["nns"]
            assert len(self.dataset) == self.nns.shape[0]

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, ind, rng: np.random.Generator | None = None):
        rng = rng if rng is not None else np.random.default_rng()
        pack = self.dataset.__getitem__(ind, rng)

        if self.pos_images or self.pos_labels:
            ind_pos = int(self.nns[ind][int(rng.integers(1, self.num_neighbors + 1))])
            pack_pos = self.dataset.__getitem__(ind_pos, rng)

        extra = self.extra_transform or (lambda i, x: x)

        img = pack["img"]
        coord = np.stack(np.meshgrid(
            np.linspace(-1, 1, img.shape[1]),
            np.linspace(-1, 1, img.shape[2]), indexing="ij")).astype(np.float32)

        ret = {"ind": ind, "img": extra(ind, img), "label": extra(ind, pack["label"])}

        if self.return_depth:
            ret["depth"] = extra(ind, pack["depth"])
        if self.pos_images:
            ret["img_pos"] = extra(ind, pack_pos["img"])
            ret["ind_pos"] = ind_pos
            if self.return_depth:
                ret["depth_pos"] = extra(ind, pack_pos["depth"])
        if self.mask:
            ret["mask"] = pack["mask"]
        if self.pos_labels:
            ret["label_pos"] = extra(ind, pack_pos["label"])
            ret["mask_pos"] = pack_pos["mask"]

        if self.aug_photometric_transform is not None:
            from PIL import Image

            geo = self.aug_geometric_transform
            params = geo.sample(rng, img.shape[2], img.shape[1])
            # photometric on the geometric crop of the (denormalized) image
            img_geo = geo.apply_image(img, params)
            denorm = np.clip(T.unnormalize(img_geo) * 255, 0, 255).astype(np.uint8)
            pil = Image.fromarray(denorm.transpose(1, 2, 0))
            pil = self.aug_photometric_transform(rng, pil)
            img_aug = T.normalize_array(T.image_to_array(pil))
            coord_aug = geo.apply_image(coord, params)
            ret["img_aug"] = img_aug.astype(np.float32)
            ret["coord_aug"] = coord_aug.transpose(1, 2, 0).astype(np.float32)
        return ret
