"""Metric-depth fine-tune data pipeline (the reference's ``DataLoadPreprocess``).

Reference behavior reproduced (NOT its torch/cv2 structure) from
``src/zoedepth/data/data_mono.py``:

* filenames files — one sample per line, ``image_rel depth_rel focal``
  (KITTI ``use_right`` adds right-camera paths at fields 3/4, taken with
  p=0.5 at train time: ``data_mono.py:298-307``);
* train: optional kb-crop to 352x1216 (``data_mono.py:313-321``), NYU
  white-border avoidance crop + reflect pad (``325-340``), random rotation
  of image (bilinear) and depth (nearest) by U(-degree, degree)
  (``343-347``), image -> f32/255, depth /1000 (nyu) or /256 (others)
  (``349-356``), random crop to (input_height, input_width) (``358-360``,
  ``444-454``), optional random integer translation (``456-471``), random
  horizontal flip + photometric aug (gamma/brightness/per-channel color,
  brightness range wider for nyu) each with p=0.5 (``473-507``), validity
  mask = depth in (min_depth, max_depth) (``367-368``);
* online_eval: image f32/255, depth scaled as above, missing depth
  tolerated (``has_valid_depth``, ``383-406``), kb-crop applied to both
  (``408-417``), mask uses >=/<= at eval (``403-404``) then is overwritten
  by the strict mask when depth is valid (``426-429`` — replicated
  faithfully, including the overwrite);
* ToTensor (``513-541``): CHW float tensors, NO ImageNet normalization by
  default (``do_normalize=False`` — ZoeDepth's own ``PrepForMidas``
  normalizes inside the model), optional square resize when
  ``do_input_resize``;
* ``RepetitiveRoundRobinLoader`` (``181-213``): samplewise round-robin over
  several datasets, shorter ones cycling, with the reference's
  length quirk (``len = n_loaders * (max_len + 1)``).

TPU-first notes: randomness is an explicit per-index ``numpy`` Generator
seeded from (seed, index) — the reference's global ``random`` module state
is not reproducible across workers; batches are plain numpy dicts staged by
the caller (``scripts/finetune_zoedepth.py`` packs them host-side and
device_puts once per step).
"""

from __future__ import annotations

import dataclasses
import itertools
import os

import numpy as np
from PIL import Image

from depthg_tpu_torch.models.zoedepth.config import DEPTH_DATASETS, datasets_config


@dataclasses.dataclass(frozen=True)
class MonoDepthDataConfig:
    """The config keys ``DataLoadPreprocess`` reads, defaulted from the
    reference's DATASETS_CONFIG + COMMON_TRAINING_CONFIG."""
    dataset: str = "nyu"
    data_path: str = ""
    gt_path: str = ""
    filenames_file: str = ""
    data_path_eval: str = ""
    gt_path_eval: str = ""
    filenames_file_eval: str = ""
    input_height: int = 480
    input_width: int = 640
    min_depth: float = 1e-3
    max_depth: float = 10.0
    do_kb_crop: bool = False
    do_random_rotate: bool = True
    degree: float = 1.0
    aug: bool = True
    random_crop: bool = False
    random_translate: bool = False
    max_translation: int = 100
    translate_prob: float = 0.2
    use_right: bool = False
    avoid_boundary: bool = False
    seed: int = 0

    @classmethod
    def for_dataset(cls, name: str, data_root: str | None = None, **over):
        spec = DEPTH_DATASETS[name]
        d = datasets_config(name, data_root)
        base = d["root"]
        return cls(dataset=name,
                   data_path=over.pop("data_path", base),
                   gt_path=over.pop("gt_path", base),
                   data_path_eval=over.pop("data_path_eval", base),
                   gt_path_eval=over.pop("gt_path_eval", base),
                   input_height=spec.input_height or 480,
                   input_width=spec.input_width or 640,
                   min_depth=spec.min_depth, max_depth=spec.max_depth,
                   do_kb_crop=spec.do_kb_crop,
                   do_random_rotate=spec.do_random_rotate,
                   degree=spec.degree, use_right=spec.use_right,
                   avoid_boundary=spec.avoid_boundary, **over)


def _remove_leading_slash(s: str) -> str:
    return s[1:] if s[:1] in ("/", "\\") else s


def _white_border(img_u8: np.ndarray, value: int = 255, tolerance: int = 3):
    """(top, bottom, left, right) of the non-white interior (the reference's
    ``get_white_border``, data/preprocess.py): the largest run of rows/cols
    at each edge whose mean is within tolerance of pure white."""
    near = np.abs(img_u8.astype(np.int32).mean(axis=-1) - value) <= tolerance
    h, w = near.shape

    def run(mask_1d):
        n = 0
        for v in mask_1d:
            if not v:
                break
            n += 1
        return n

    row_white = near.all(axis=1)
    col_white = near.all(axis=0)
    top = run(row_white)
    bottom = h - run(row_white[::-1])
    left = run(col_white)
    right = w - run(col_white[::-1])
    return top, bottom, left, right


def _kb_crop_box(width: int, height: int):
    """KITTI benchmark crop (352 x 1216): data_mono.py:313-321."""
    top = int(height - 352)
    left = int((width - 1216) / 2)
    return left, top, left + 1216, top + 352


class DataLoadPreprocess:
    """Indexable dataset of fine-tune samples (reference data_mono.py:270-510).

    ``mode``: "train" | "online_eval" | "test". Returns numpy dicts:
    train -> {image [3,H,W] f32 0..1, depth [1,H,W] metric, mask [1,H,W]
    bool, focal, dataset}; online_eval adds ``has_valid_depth`` and keeps
    native (un-cropped-to-train-size) resolution.
    """

    def __init__(self, config: MonoDepthDataConfig, mode: str):
        self.config = config
        self.mode = mode
        fname = (config.filenames_file_eval if mode == "online_eval"
                 else config.filenames_file)
        with open(fname) as f:
            self.filenames = [ln for ln in f.read().splitlines() if ln.strip()]

    def __len__(self):
        return len(self.filenames)

    # -- train-time transforms (reference line refs in the module docstring) --

    def _rotate(self, img: Image.Image, angle: float, nearest: bool):
        return img.rotate(angle, resample=Image.NEAREST if nearest
                          else Image.BILINEAR)

    def _random_crop(self, rng, img, depth):
        h, w = self.config.input_height, self.config.input_width
        assert img.shape[0] >= h and img.shape[1] >= w
        x = rng.integers(0, img.shape[1] - w + 1)
        y = rng.integers(0, img.shape[0] - h + 1)
        return img[y:y + h, x:x + w], depth[y:y + h, x:x + w]

    def _random_translate(self, rng, img, depth):
        if rng.random() > self.config.translate_prob:
            return img, depth
        mt = self.config.max_translation
        tx = int(rng.integers(-mt, mt + 1))
        ty = int(rng.integers(-mt, mt + 1))

        # integer-translation warp with zero fill (cv2.warpAffine semantics
        # for a pure-translation matrix)
        def warp(a):
            out = np.zeros_like(a)
            src_y = slice(max(0, -ty), min(a.shape[0], a.shape[0] - ty))
            dst_y = slice(max(0, ty), max(0, ty) + (src_y.stop - src_y.start))
            src_x = slice(max(0, -tx), min(a.shape[1], a.shape[1] - tx))
            dst_x = slice(max(0, tx), max(0, tx) + (src_x.stop - src_x.start))
            out[dst_y, dst_x] = a[src_y, src_x]
            return out

        return warp(img), warp(depth)

    def _augment_image(self, rng, image):
        gamma = rng.uniform(0.9, 1.1)
        image = image ** gamma
        lo, hi = ((0.75, 1.25) if self.config.dataset == "nyu" else (0.9, 1.1))
        image = image * rng.uniform(lo, hi)
        colors = rng.uniform(0.9, 1.1, size=3)
        image = np.clip(image * colors[None, None, :], 0.0, 1.0)
        return image.astype(np.float32)

    def _train_preprocess(self, rng, image, depth):
        if self.config.aug:
            if rng.random() > 0.5:
                image = image[:, ::-1].copy()
                depth = depth[:, ::-1].copy()
            if rng.random() > 0.5:
                image = self._augment_image(rng, image)
        return image, depth

    def _depth_scale(self) -> float:
        return 1000.0 if self.config.dataset == "nyu" else 256.0

    def __getitem__(self, idx: int) -> dict:
        cfg = self.config
        fields = self.filenames[idx].split()
        focal = float(fields[2]) if len(fields) > 2 else 0.0
        rng = np.random.default_rng((cfg.seed, idx))

        if self.mode == "train":
            if cfg.dataset == "kitti" and cfg.use_right and rng.random() > 0.5:
                img_rel, gt_rel = fields[3], fields[4]
            else:
                img_rel, gt_rel = fields[0], fields[1]
            image = Image.open(os.path.join(cfg.data_path,
                                            _remove_leading_slash(img_rel)))
            depth_gt = Image.open(os.path.join(cfg.gt_path,
                                               _remove_leading_slash(gt_rel)))
            w, h = image.size

            if cfg.do_kb_crop:
                box = _kb_crop_box(image.width, image.height)
                image, depth_gt = image.crop(box), depth_gt.crop(box)

            if cfg.dataset == "nyu" and cfg.avoid_boundary:
                top, bottom, left, right = _white_border(
                    np.asarray(image, np.uint8))
                image_c = np.asarray(image.crop((left, top, right, bottom)))
                image = Image.fromarray(np.pad(
                    image_c, ((top, h - bottom), (left, w - right), (0, 0)),
                    mode="reflect"))
                depth_c = np.asarray(depth_gt.crop((left, top, right, bottom)))
                depth_gt = Image.fromarray(np.pad(
                    depth_c, ((top, h - bottom), (left, w - right)),
                    mode="constant"))

            if cfg.do_random_rotate and cfg.aug:
                angle = (rng.random() - 0.5) * 2 * cfg.degree
                image = self._rotate(image, angle, nearest=False)
                depth_gt = self._rotate(depth_gt, angle, nearest=True)

            image = np.asarray(image, np.float32) / 255.0
            depth = np.asarray(depth_gt, np.float32)[..., None] / self._depth_scale()

            if cfg.aug and cfg.random_crop:
                image, depth = self._random_crop(rng, image, depth)
            if cfg.aug and cfg.random_translate:
                image, depth = self._random_translate(rng, image, depth)
            image, depth = self._train_preprocess(rng, image, depth)
            mask = np.logical_and(depth > cfg.min_depth,
                                  depth < cfg.max_depth)
            return {"image": image.transpose(2, 0, 1),
                    "depth": depth.transpose(2, 0, 1),
                    "mask": mask.transpose(2, 0, 1),
                    "focal": focal, "dataset": cfg.dataset,
                    "image_path": fields[0], "depth_path": fields[1]}

        # online_eval / test
        data_path = cfg.data_path_eval if self.mode == "online_eval" else cfg.data_path
        image = np.asarray(Image.open(os.path.join(
            data_path, _remove_leading_slash(fields[0]))), np.float32) / 255.0
        sample = {"image": None, "focal": focal, "dataset": cfg.dataset,
                  "image_path": fields[0],
                  "depth_path": fields[1] if len(fields) > 1 else ""}

        depth = None
        has_valid_depth = False
        if self.mode == "online_eval":
            try:
                depth_img = Image.open(os.path.join(
                    cfg.gt_path_eval, _remove_leading_slash(fields[1])))
                depth = np.asarray(depth_img, np.float32)[..., None] \
                    / self._depth_scale()
                has_valid_depth = True
            except (OSError, IndexError):
                depth = None
            sample["has_valid_depth"] = has_valid_depth

        if cfg.do_kb_crop:
            left, top, right, bottom = _kb_crop_box(
                image.shape[1], image.shape[0])
            image = image[top:bottom, left:right]
            if has_valid_depth:
                depth = depth[top:bottom, left:right]

        sample["image"] = image.transpose(2, 0, 1)
        if has_valid_depth:
            # strict mask overwrite, data_mono.py:426-429
            mask = np.logical_and(depth > cfg.min_depth,
                                  depth < cfg.max_depth)
            sample["depth"] = depth.transpose(2, 0, 1)
            sample["mask"] = mask.transpose(2, 0, 1)
        return sample


def repetitive_roundrobin(*iterables):
    """Samplewise round-robin; exhausted iterables cycle (data_mono.py:181-201)."""
    its = [iter(it) for it in iterables]
    exhausted = [False] * len(iterables)
    while not all(exhausted):
        for i in range(len(its)):
            try:
                yield next(its[i])
            except StopIteration:
                exhausted[i] = True
                its[i] = itertools.cycle(iterables[i])
                yield next(its[i])


class RepetitiveRoundRobinLoader:
    """Mix several sample sources samplewise (MixedNYUKITTI's train loader,
    data_mono.py:204-213 — including its +1 length quirk)."""

    def __init__(self, *loaders):
        self.loaders = loaders

    def __iter__(self):
        return repetitive_roundrobin(*self.loaders)

    def __len__(self):
        return len(self.loaders) * (max(len(l) for l in self.loaders) + 1)


def batched(dataset, batch_size: int, order=None):
    """Group dataset samples into stacked numpy batches (train mode)."""
    order = range(len(dataset)) if order is None else order
    buf = []
    for i in order:
        buf.append(dataset[i])
        if len(buf) == batch_size:
            yield {k: (np.stack([s[k] for s in buf])
                       if isinstance(buf[0][k], np.ndarray) else
                       [s[k] for s in buf])
                   for k in buf[0]}
            buf = []
