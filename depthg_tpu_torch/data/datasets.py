"""Dataset readers for the DepthG data layout (PIL + numpy, torch-free).

Directory structures, split files, label maps and depth-file conventions match
the reference ``src/data.py`` exactly (citations inline). Each dataset returns
a dict ``{"img": f32 [3,R,R] (ImageNet-normalized), "label": i64 [R,R],
"mask": f32/bool [R,R], "depth": f32 [1,?,?] (optional)}``.

Randomness is explicit: ``__getitem__(index, rng)`` draws crop offsets from a
``np.random.Generator`` and applies identical offsets to img/label/depth
(replacing the reference's global-seed sync trick, ``src/data.py:116-124``).

Scale quirks preserved on purpose:
* ``CroppedDataset`` depth goes through the *label* transform, so 8-bit depth
  PNGs arrive as floats in 0..255 (reference ``src/data.py:894-895`` applies
  ``ToTargetTensor`` which does not rescale) — this is the scale the FPS
  geometry was tuned on;
* ``Potsdam`` zoedepth arrives via ``to_tensor`` as [0, 1]
  (``src/data.py:193``); kbr/gt are min-max normalized;
* ``CityscapesSeg.mask`` is the *void* mask (``target == -1``,
  ``src/data.py:508``) while ``Potsdam.mask`` is ``label > 0``
  (``src/data.py:237``) — opposite polarities, as in the reference.
"""

from __future__ import annotations

import os
import warnings
from os.path import join

import numpy as np
from PIL import Image, ImageFile

from depthg_tpu_torch.data import transforms as T

ImageFile.LOAD_TRUNCATED_IMAGES = True


class _DecodedImageCache:
    """Bounded LRU of decoded PIL images, keyed by (path, convert-mode).

    Training revisits every image thousands of times and this host decodes
    on a single core — caching the DECODED image (pre-transform, so crop/aug
    randomness is untouched) removes the repeated JPEG cost. Thread-safe for
    the loader pool; entries are fully loaded (immutable pixel buffers), so
    concurrent readers are fine. Sized in MB via ``configure`` (cfg key
    ``image_cache_mb``; 0 disables). OFF by default: one-pass workloads (a
    single eval sweep) get zero hits and would pay pure RSS; the train CLI —
    the workload that revisits every image each epoch — turns it on
    (``scripts/train_segmentation.py``), and any cfg can set
    ``image_cache_mb`` explicitly."""

    def __init__(self, budget_mb: int = 0):
        import threading
        from collections import OrderedDict

        self._lock = threading.Lock()
        self._data: "OrderedDict" = OrderedDict()
        self._size = 0
        self._budget = budget_mb * 2 ** 20

    def configure(self, budget_mb: int) -> None:
        with self._lock:
            self._budget = int(budget_mb) * 2 ** 20
            self._evict()

    def _evict(self) -> None:
        while self._size > self._budget and self._data:
            _, (img, nbytes) = self._data.popitem(last=False)
            self._size -= nbytes

    def open(self, path: str, convert: str | None = None):
        key = (path, convert)
        with self._lock:
            hit = self._data.get(key)
            if hit is not None:
                self._data.move_to_end(key)
                return hit[0]
        img = Image.open(path)
        img = img.convert(convert) if convert else img
        img.load()
        # bytes per band by mode: 16-bit depth PNGs (I;16*) are 2, 32-bit
        # int/float (I, F) are 4 — counting them as 1 would let the real
        # RSS exceed the configured budget up to 4x
        bpb = 2 if img.mode.startswith("I;16") else \
            4 if img.mode in ("I", "F") else 1
        nbytes = img.width * img.height * len(img.getbands()) * bpb
        with self._lock:
            if 0 < nbytes <= self._budget and key not in self._data:
                self._data[key] = (img, nbytes)
                self._size += nbytes
                self._evict()
        return img


IMAGE_CACHE = _DecodedImageCache()


def open_image(path: str, convert: str | None = None):
    """Image.open + optional convert, through the decoded-image LRU."""
    return IMAGE_CACHE.open(path, convert)


def create_pascal_label_colormap() -> np.ndarray:
    """Standard PASCAL VOC bit-shuffle colormap (512 entries)."""
    colormap = np.zeros((512, 3), dtype=int)
    ind = np.arange(512, dtype=int)
    for shift in reversed(range(8)):
        for channel in range(3):
            colormap[:, channel] |= ((ind >> channel) & 1) << shift
        ind >>= 3
    return colormap


def create_cityscapes_colormap() -> np.ndarray:
    colors = [
        (128, 64, 128), (244, 35, 232), (250, 170, 160), (230, 150, 140),
        (70, 70, 70), (102, 102, 156), (190, 153, 153), (180, 165, 180),
        (150, 100, 100), (150, 120, 90), (153, 153, 153), (153, 153, 153),
        (250, 170, 30), (220, 220, 0), (107, 142, 35), (152, 251, 152),
        (70, 130, 180), (220, 20, 60), (255, 0, 0), (0, 0, 142), (0, 0, 70),
        (0, 60, 100), (0, 0, 90), (0, 0, 110), (0, 80, 100), (0, 0, 230),
        (119, 11, 32), (0, 0, 0)]
    return np.array(colors)


# COCO-Stuff fine (182) -> coarse (27) map, reference ``src/data.py:351-367``.
_COCO_RANGES = [
    (0, 0, 9), (1, 8, 11), (9, 14, 8), (15, 24, 7), (25, 32, 6), (33, 42, 10),
    (43, 50, 5), (51, 60, 2), (61, 70, 3), (71, 76, 0), (77, 82, 1), (83, 90, 4),
]
_COCO_TAIL = [17, 17, 22, 20, 20, 22, 15, 25, 16, 13, 12, 12, 17, 17, 23, 15,
              15, 17, 15, 21, 15, 25, 13, 13, 13, 13, 13, 22, 26, 14, 14, 15,
              22, 21, 21, 24, 20, 22, 15, 17, 16, 15, 22, 24, 21, 17, 25, 16,
              21, 17, 22, 16, 21, 21, 25, 21, 26, 21, 24, 20, 17, 14, 21, 26,
              15, 23, 20, 21, 24, 15, 24, 22, 25, 15, 20, 17, 17, 22, 14, 18,
              18, 18, 18, 18, 18, 18, 26, 26, 19, 19, 24]


def coco_fine_to_coarse() -> np.ndarray:
    table = np.zeros(182, np.int64)
    for lo, hi, c in _COCO_RANGES:
        table[lo:hi + 1] = c
    table[91:] = _COCO_TAIL
    return table


_POTSDAM_FINE_TO_COARSE = {0: 0, 4: 0, 1: 1, 5: 1, 2: 2, 3: 2, 255: -1}


def _remap(label: np.ndarray, mapping: dict) -> np.ndarray:
    out = np.zeros_like(label)
    for fine, coarse in mapping.items():
        out[label == fine] = coarse
    return out


def _minmax(arr: np.ndarray) -> np.ndarray:
    lo, hi = arr.min(), arr.max()
    return (arr - lo) / max(hi - lo, 1e-12)


def _open_depth_01(path: str) -> np.ndarray:
    """Depth PNG -> float32 [1, H, W] scaled like torchvision to_tensor."""
    return T.image_to_array(open_image(path))[:1]


class _Base:
    """Common paired-transform application."""

    transform: T.Transform
    target_transform: T.Transform

    def _apply_pair(self, rng, img_pil, label_pil, depth_arr=None):
        rng = rng if rng is not None else np.random.default_rng()
        params = self.transform.crop_params(img_pil, rng)
        img = self.transform.apply(img_pil, params)
        label = self.target_transform.apply(label_pil, params)
        depth = None
        if depth_arr is not None:
            tt = self.target_transform
            if getattr(tt, "res", None) is None:  # RawTransform: tensorize only
                depth = depth_arr.astype(np.float32)
            else:
                # depth follows the same geometry as the label (NEAREST + crop)
                dpil = Image.fromarray(depth_arr[0].astype(np.float32), mode="F")
                dres = T.resize_shorter(dpil, (tt.res, tt.res)
                                        if tt.crop_type is None else tt.res)
                if tt.crop_type == "center":
                    dres = T.center_crop(dres, tt.res)
                elif tt.crop_type == "random":
                    dres = T.random_crop(dres, tt.res, *params)
                depth = np.asarray(dres, np.float32)[None]
        return img, label, depth

    def __len__(self):
        raise NotImplementedError


class DirectoryDataset(_Base):
    """Generic imgs/labels folder pairs (reference ``src/data.py:87-132``)."""

    def __init__(self, root, image_set, transform, target_transform, path=None):
        self.split = image_set
        self.dir = root
        self.img_dir = join(self.dir, "imgs", self.split)
        self.label_dir = join(self.dir, "labels", self.split)
        self.transform = transform
        self.target_transform = target_transform
        self.img_files = np.array(sorted(os.listdir(self.img_dir)))
        assert len(self.img_files) > 0
        if os.path.exists(join(self.dir, "labels")):
            self.label_files = np.array(sorted(os.listdir(self.label_dir)))
            assert len(self.img_files) == len(self.label_files)
        else:
            self.label_files = None
        self.filepaths = [join(self.img_dir, f) for f in self.img_files]

    def __getitem__(self, index, rng=None):
        img_pil = open_image(join(self.img_dir, self.img_files[index]))
        if self.label_files is not None:
            label_pil = open_image(join(self.label_dir, self.label_files[index]))
        else:
            label_pil = None
        if label_pil is not None:
            img, label, _ = self._apply_pair(rng, img_pil, label_pil)
        else:
            img = self.transform(img_pil, rng)
            label = np.full(img.shape[1:], -1, np.int64)
        return {"img": img, "label": label, "mask": (label > 0).astype(np.float32)}

    def __len__(self):
        return len(self.img_files)


class Potsdam(_Base):
    """ISPRS Potsdam .mat tiles + split txts (reference ``src/data.py:135-241``)."""

    SPLIT_FILES = {
        "train": ["labelled_train.txt"],
        "unlabelled_train": ["unlabelled_train.txt"],
        "val": ["labelled_test.txt"],
        "train+val": ["labelled_train.txt", "labelled_test.txt"],
        "all": ["all.txt"],
    }

    def __init__(self, root, image_set, transform, target_transform,
                 coarse_labels, return_depth=False, depth_type="zoedepth"):
        from scipy.io import loadmat  # lazy; only Potsdam needs it
        self._loadmat = loadmat
        self.split = image_set
        self.root = os.path.join(root, "potsdam")
        self.transform = transform
        self.target_transform = target_transform
        self.return_depth = return_depth
        self.depth_type = depth_type
        self.coarse_labels = coarse_labels
        assert self.split in self.SPLIT_FILES
        self.files = []
        for split_file in self.SPLIT_FILES[self.split]:
            with open(join(self.root, split_file)) as f:
                self.files.extend(fn.rstrip() for fn in f.readlines())
        self.filepaths = [join(self.root, "imgs", fn + ".png") for fn in self.files]

    def _load_depth(self, image_id, size):
        try:
            if self.depth_type == "zoedepth":
                d = _open_depth_01(join(self.root, "zoe_depth", self.split, "imgs",
                                        image_id + "_zoedepth.png"))
            elif self.depth_type == "kbr":
                arr = T.image_to_array(open_image(
                    join(self.root, "kbr_depth", self.split, image_id + ".png")))
                assert arr.shape[0] == 3, "KBR depth map should have 3 channels"
                d = _minmax(arr.mean(0, keepdims=True))
            elif self.depth_type == "gt":
                d = _minmax(_open_depth_01(join(self.root, "gt_depth", image_id + ".png")))
            else:
                raise NotImplementedError(self.depth_type)
            return d.astype(np.float32)
        except (FileNotFoundError, OSError):
            warnings.warn(f"Depth file not found for image {image_id}")
            return np.zeros((1, *size), np.float32)

    def __getitem__(self, index, rng=None):
        image_id = self.files[index]
        img_arr = self._loadmat(join(self.root, "imgs", image_id + ".mat"))["img"]
        img_pil = Image.fromarray(np.asarray(img_arr)[:, :, :3].astype(np.uint8))
        try:
            gt = self._loadmat(join(self.root, "gt", image_id + ".mat"))["gt"]
            label_pil = Image.fromarray(np.asarray(gt).astype(np.uint8))
        except FileNotFoundError:
            label_pil = Image.fromarray(np.ones((img_pil.height, img_pil.width), np.uint8))

        depth_arr = (self._load_depth(image_id, (img_pil.height, img_pil.width))
                     if self.return_depth else np.zeros((1, img_pil.height, img_pil.width), np.float32))

        img, label, depth = self._apply_pair(rng, img_pil, label_pil, depth_arr)
        if self.coarse_labels:
            label = _remap(label, _POTSDAM_FINE_TO_COARSE)
        return {"img": img, "label": label,
                "mask": (label > 0).astype(np.float32), "depth": depth}

    def __len__(self):
        return len(self.files)


class PotsdamRaw(_Base):
    """38 x 15 x 15 raw tiles (reference ``src/data.py:244-292``)."""

    def __init__(self, root, image_set, transform, target_transform, coarse_labels):
        from scipy.io import loadmat
        self._loadmat = loadmat
        self.root = os.path.join(root, "potsdamraw", "processed")
        self.transform = transform
        self.target_transform = target_transform
        self.coarse_labels = coarse_labels
        self.files = [f"{im}_{ih}_{iw}.mat"
                      for im in range(38) for ih in range(15) for iw in range(15)]

    def __getitem__(self, index, rng=None):
        fid = self.files[index]
        img_arr = self._loadmat(join(self.root, "imgs", fid))["img"]
        img_pil = Image.fromarray(np.asarray(img_arr)[:, :, :3].astype(np.uint8))
        try:
            gt = self._loadmat(join(self.root, "gt", fid))["gt"]
            label_pil = Image.fromarray(np.asarray(gt).astype(np.uint8))
        except FileNotFoundError:
            label_pil = Image.fromarray(np.ones((img_pil.height, img_pil.width), np.uint8))
        img, label, _ = self._apply_pair(rng, img_pil, label_pil)
        if self.coarse_labels:
            label = _remap(label, _POTSDAM_FINE_TO_COARSE)
        return {"img": img, "label": label, "mask": (label > 0).astype(np.float32)}

    def __len__(self):
        return len(self.files)


class Coco(_Base):
    """COCO-Stuff with curated split lists (reference ``src/data.py:295-449``)."""

    SPLIT_DIRS = {"train": ["train2017"], "val": ["val2017"],
                  "train+val": ["train2017", "val2017"], "demo": ["demo"]}

    def __init__(self, root, image_set, transform, target_transform,
                 coarse_labels, exclude_things, subset=None,
                 return_depth=False, depth_type="zoedepth"):
        self.split = image_set
        self.root = join(root, "cocostuff")
        self.coarse_labels = coarse_labels
        self.transform = transform
        self.target_transform = target_transform
        self.subset = subset
        self.exclude_things = exclude_things
        self.return_depth = return_depth
        self.depth_type = depth_type

        if subset is None:
            image_list = "Coco164kFull_Stuff_Coarse.txt"
        elif subset == 6:
            image_list = "Coco164kFew_Stuff_6.txt"
        elif subset == 7:
            image_list = "Coco164kFull_Stuff_Coarse_7.txt"
        else:
            raise ValueError(subset)

        assert self.split in self.SPLIT_DIRS
        self.image_files, self.label_files, self.depth_files = [], [], []
        for split_dir in self.SPLIT_DIRS[self.split]:
            with open(join(self.root, "curated", split_dir, image_list)) as f:
                for img_id in (fn.rstrip() for fn in f.readlines()):
                    self.image_files.append(join(self.root, "images", split_dir, img_id + ".jpg"))
                    self.label_files.append(join(self.root, "annotations", split_dir, img_id + ".png"))
                    if return_depth:
                        if depth_type == "zoedepth":
                            self.depth_files.append(join(self.root, "depth", split_dir,
                                                         img_id + "_zoedepth.png"))
                        elif depth_type == "kbr":
                            self.depth_files.append(join(self.root, "kbr_depth", split_dir,
                                                         img_id + ".png"))
                        elif depth_type == "midas":
                            self.depth_files.append(join(self.root, "midas_depth", split_dir,
                                                         img_id + "_midas.png"))
                        else:
                            raise NotImplementedError(depth_type)
        self.filepaths = self.image_files
        self.fine_to_coarse = coco_fine_to_coarse()
        self.cocostuff3_coarse_classes = [23, 22, 21]
        self.first_stuff_index = 12

    def __getitem__(self, index, rng=None):
        img_pil = open_image(self.image_files[index], "RGB")
        label_pil = open_image(self.label_files[index])
        img, label, _ = self._apply_pair(rng, img_pil, label_pil)

        depth = None
        if self.return_depth:
            # reference quirk: Coco depth is NOT spatially transformed
            # (``src/data.py:391-420``); only kbr gets channel-mean + minmax
            depth = T.image_to_array(open_image(self.depth_files[index]))
            if self.depth_type == "kbr":
                depth = _minmax(depth.mean(0, keepdims=True))
            else:
                depth = depth[:1]

        label = label.copy()
        label[label == 255] = -1
        coarse = np.where(label >= 0, self.fine_to_coarse[np.clip(label, 0, 181)], 0)
        coarse[label == -1] = -1

        if self.coarse_labels:
            coarser = -np.ones_like(label)
            for i, c in enumerate(self.cocostuff3_coarse_classes):
                coarser[coarse == c] = i
            out = {"img": img, "label": coarser, "mask": coarser >= 0}
        elif self.exclude_things:
            out = {"img": img, "label": coarse - self.first_stuff_index,
                   "mask": coarse >= self.first_stuff_index}
        else:
            out = {"img": img, "label": coarse, "mask": coarse >= 0}
        if depth is not None:
            out["depth"] = depth
        return out

    def __len__(self):
        return len(self.image_files)


class CityscapesSeg(_Base):
    """Cityscapes fine annotations via direct folder scan
    (reference wraps torchvision, ``src/data.py:452-524``)."""

    def __init__(self, root, image_set, transform, target_transform,
                 return_depth=False, depth_type="zoedepth"):
        self.split = image_set
        self.root = join(root, "cityscapes")
        mode_dir = "gtFine"
        img_root = join(self.root, "leftImg8bit", image_set)
        self.images, self.targets = [], []
        for city in sorted(os.listdir(img_root)):
            for fn in sorted(os.listdir(join(img_root, city))):
                self.images.append(join(img_root, city, fn))
                base = fn.replace("_leftImg8bit.png", "")
                self.targets.append(join(self.root, mode_dir, image_set, city,
                                         f"{base}_{mode_dir}_labelIds.png"))
        self.filepaths = self.images
        self.transform = transform
        self.target_transform = target_transform
        self.first_nonvoid = 7
        self.return_depth = return_depth
        self.depth_type = depth_type
        self.depth_folder_path = join(root, "cityscapes", "depth", image_set)

    def __getitem__(self, index, rng=None):
        img_pil = open_image(self.images[index], "RGB")
        label_pil = open_image(self.targets[index])
        img, label, _ = self._apply_pair(rng, img_pil, label_pil)

        depth = None
        if self.return_depth:
            if self.depth_type != "zoedepth":
                raise NotImplementedError(self.depth_type)
            path = self.images[index]
            stem = os.path.splitext(os.path.basename(path))[0]
            city = os.path.basename(os.path.dirname(path))
            depth = _open_depth_01(join(self.depth_folder_path, city, stem + "_zoedepth.png"))

        label = label - self.first_nonvoid
        label[label < 0] = -1
        out = {"img": img, "label": label, "mask": label == -1}
        if depth is not None:
            out["depth"] = depth
        return out

    def __len__(self):
        return len(self.images)


class NYUv2(_Base):
    """NYUv2 rgb/seg13/depth folder layout (reference ``src/data.py:527-736``)."""

    def __init__(self, root, image_set, transform, target_transform,
                 return_depth=False, depth_type="gt"):
        self.root = root
        self.transform = transform
        self.target_transform = target_transform
        self.return_depth = return_depth
        self.depth_type = depth_type
        self._split = "test" if image_set == "val" else image_set
        assert self._split in ("train", "test")
        self._files = sorted(os.listdir(os.path.join(root, f"{self._split}_rgb")))
        self.filepaths = self._files

    def _folder(self, name):
        return os.path.join(self.root, f"{self._split}_{name}")

    def __getitem__(self, index, rng=None):
        fn = self._files[index]
        img_pil = open_image(os.path.join(self._folder("rgb"), fn))
        label_pil = open_image(os.path.join(self._folder("seg13"), fn))
        img, label, _ = self._apply_pair(rng, img_pil, label_pil)

        out = {"img": img, "label": label, "mask": np.zeros_like(label, np.float32)}
        if self.return_depth:
            if self.depth_type == "gt":
                raw = np.asarray(open_image(os.path.join(self._folder("depth"), fn)))
            elif self.depth_type == "zoedepth":
                raw = np.asarray(open_image(os.path.join(
                    self._folder("zoedepth_depth"), fn.replace(".png", "_zoedepth.png"))))
            elif self.depth_type in ("kbr", "midas"):
                raw = np.asarray(open_image(os.path.join(self._folder(f"{self.depth_type}_depth"), fn)))
            else:
                raise NotImplementedError(self.depth_type)
            # uint16 depth scaled /1e4 then min-max normalized (src/data.py:621-627)
            d = raw.astype(np.float32)
            if raw.dtype == np.uint16:
                d = d / 65535.0  # to_tensor scaling
            elif raw.dtype == np.uint8:
                d = d / 255.0
            d = d / 1e4
            out["depth"] = _minmax(d)[None]
        return out

    def __len__(self):
        return len(self._files)


class PascalVOC(_Base):
    """VOC2012 segmentation + depth sidecars (reference ``src/data.py:739-812``)."""

    def __init__(self, root, image_set, transform, target_transform,
                 return_depth=False, depth_type="zoedepth"):
        self.root = join(root, "pascalvoc")
        voc_root = join(self.root, "VOCdevkit", "VOC2012")
        split_f = join(voc_root, "ImageSets", "Segmentation", image_set + ".txt")
        with open(split_f) as f:
            names = [x.strip() for x in f.readlines()]
        self.images = [join(voc_root, "JPEGImages", n + ".jpg") for n in names]
        self.masks = [join(voc_root, "SegmentationClass", n + ".png") for n in names]
        self.filepaths = self.images
        self.transform = transform
        self.target_transform = target_transform
        self.return_depth = return_depth
        self.depth_type = depth_type
        if return_depth:
            if depth_type == "zoedepth":
                dp = f"zoe_depth/{image_set}/JPEGImages"
                self.depth = [join(self.root, dp, os.path.basename(i).replace(".jpg", "_zoedepth.png"))
                              for i in self.images]
            elif depth_type == "kbr":
                dp = f"kbr_depth/{image_set}/JPEGImages"
                self.depth = [join(self.root, dp, os.path.basename(i).replace(".jpg", ".png"))
                              for i in self.images]
            elif depth_type == "midas":
                dp = f"midas_depth/{image_set}/JPEGImages"
                self.depth = [join(self.root, dp, os.path.basename(i).replace(".jpg", "_midas.png"))
                              for i in self.images]
            else:
                raise NotImplementedError(depth_type)

    def __getitem__(self, index, rng=None):
        img_pil = open_image(self.images[index], "RGB")
        label_pil = open_image(self.masks[index])
        img, label, _ = self._apply_pair(rng, img_pil, label_pil)
        label = label.copy()
        label[label > 20] = -1
        out = {"img": img, "label": label, "mask": label == -1}
        if self.return_depth:
            raw = np.asarray(open_image(self.depth[index]))
            d = raw.astype(np.float32)
            if raw.dtype == np.uint16:
                d = d / 65535.0
            elif raw.dtype == np.uint8:
                d = d / 255.0
            # resized NEAREST to the transform res (src/data.py:776-778)
            dpil = Image.fromarray(d, mode="F").resize(
                (self.transform.res, self.transform.res), Image.NEAREST)
            d = np.asarray(dpil, np.float32) / 1e4
            out["depth"] = _minmax(d)[None]
        return out

    def __len__(self):
        return len(self.images)


class CroppedDataset(_Base):
    """Reads five-crop/random-crop outputs of ``crop_datasets``
    (reference ``src/data.py:815-912``): ``cropped/{ds}_{crop}_crop_{ratio}[_{depth}]``
    with img/{i}.jpg, label/{i}.png (stored label+1), depth/{i}_{type}.png."""

    def __init__(self, root, dataset_name, crop_type, crop_ratio, image_set,
                 transform, target_transform, return_depth=False, depth_type="zoedepth"):
        self.dataset_name = dataset_name
        self.split = image_set
        if depth_type == "gt":
            assert dataset_name in ("nyuv2", "potsdam")
            self.root = join(root, "cropped", f"{dataset_name}_{crop_type}_crop_{crop_ratio}")
        elif "zoedepth" in depth_type and dataset_name != "nyuv2":
            self.root = join(root, "cropped", f"{dataset_name}_{crop_type}_crop_{crop_ratio}")
        else:
            self.root = join(root, "cropped",
                             f"{dataset_name}_{crop_type}_crop_{crop_ratio}_{depth_type}")
        self.transform = transform
        self.target_transform = target_transform
        self.img_dir = join(self.root, "img", self.split)
        self.label_dir = join(self.root, "label", self.split)
        self.depth_dir = join(self.root, "depth", self.split)
        self.return_label = os.path.exists(self.label_dir)
        if not self.return_label:
            warnings.warn("No label directory found, returning only images")
        self.plane_depth = "plane" in depth_type
        self.depth_type = depth_type.replace("_plane", "")
        self.num_images = len(os.listdir(self.img_dir))
        self.return_depth = return_depth
        self.filepaths = [join(self.img_dir, f"{i}.jpg") for i in range(self.num_images)]

    def __getitem__(self, index, rng=None):
        img_pil = open_image(join(self.img_dir, f"{index}.jpg"), "RGB")
        if self.return_label:
            label_pil = open_image(join(self.label_dir, f"{index}.png"))
        else:
            label_pil = Image.fromarray(
                np.random.randint(0, 255, size=img_pil.size[::-1], dtype=np.uint8))

        rng = rng if rng is not None else np.random.default_rng()
        params = self.transform.crop_params(img_pil, rng)
        img = self.transform.apply(img_pil, params)
        label = self.target_transform.apply(label_pil, params)

        out = {"img": img}
        depth = None
        if self.return_depth:
            dpil = open_image(join(self.depth_dir, f"{index}_{self.depth_type}.png"))
            # depth via the *label* transform: values stay 0..255 (see module doc)
            depth = self.target_transform.apply(dpil, params).astype(np.float32)[None]
            if self.plane_depth:
                depth = np.full_like(depth, 255.0)
        if self.return_label:
            label = label - 1
            out["label"] = label
            out["mask"] = label == -1
        else:
            out["label"] = label
            out["mask"] = np.zeros_like(label, bool)
        if depth is not None:
            out["depth"] = depth
        return out

    def __len__(self):
        return self.num_images


class MaterializedDataset:
    """Eagerly caches a dataset in memory (reference ``src/data.py:915-928``)."""

    def __init__(self, ds):
        self.ds = ds
        rng = np.random.default_rng(0)
        self.materialized = [ds.__getitem__(i, rng) if _takes_rng(ds) else ds[i]
                             for i in range(len(ds))]

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, ind):
        return self.materialized[ind]


def _takes_rng(ds) -> bool:
    import inspect

    try:
        return "rng" in inspect.signature(ds.__getitem__).parameters
    except (TypeError, ValueError):
        return False
