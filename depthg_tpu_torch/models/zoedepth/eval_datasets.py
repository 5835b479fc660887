"""The 8 specialized depth eval-dataset readers (reference
``src/zoedepth/data/{ibims,sun_rgbd_loader,diml_indoor_test,
diml_outdoor_test,diode,hypersim,vkitti,vkitti2,ddad}.py``).

Each is a plain indexable over a folder layout returning numpy samples
``{image [3,H,W] f32 0..1, depth [1,Hd,Wd] metric (or the reference's raw
values where the reference skips conversion), dataset, image_path}`` —
the shape ``scripts/finetune_zoedepth.py``'s validation loop consumes.
Behaviors reproduced per reader (file:line refs at each class); torch/cv2
machinery replaced with PIL + numpy + this framework's exact torch-semantic
``resize_bilinear`` (torchvision tensor Resize == F.interpolate bilinear,
align_corners=False, no antialias).
"""

from __future__ import annotations

import glob
import os

import numpy as np
from PIL import Image


def _img01(path: str) -> np.ndarray:
    """[H, W, 3] float32 image scaled to 0..1 (every reference reader)."""
    return np.asarray(Image.open(path), np.float32) / 255.0


def _chw(img_hw3: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img_hw3.transpose(2, 0, 1))


def _resize_image(img_chw: np.ndarray, size) -> np.ndarray:
    """torchvision tensor Resize semantics: int = shorter side, tuple =
    exact (H, W); bilinear align_corners=False, no antialias."""
    from depthg_tpu_torch.ops.resize import resize_bilinear_array as resize_bilinear

    h, w = img_chw.shape[-2:]
    if isinstance(size, int):
        if h <= w:
            out = (size, max(1, round(w * size / h)))
        else:
            out = (max(1, round(h * size / w)), size)
    else:
        out = tuple(size)
    if (h, w) == out:
        return img_chw
    return np.asarray(resize_bilinear(img_chw[None], out))[0]


class _Reader:
    name = ""

    def __len__(self):
        return len(self.image_files)

    def _sample(self, image_chw, depth_hw, image_path):
        return {"image": image_chw.astype(np.float32),
                "depth": depth_hw[None].astype(np.float32),
                "dataset": self.name, "image_path": image_path}


class DIMLIndoor(_Reader):
    """diml_indoor_test.py:81-118: ``LR/<scene>/color/*_c.png`` images with
    ``depth_filled`` uint16 depths (mm -> m), image resized to 480x640."""
    name = "diml_indoor"

    def __init__(self, root: str):
        self.image_files = sorted(glob.glob(
            os.path.join(root, "LR", "*", "color", "*.png")))
        self.depth_files = [p.replace("color", "depth_filled")
                             .replace("_c.png", "_depth_filled.png")
                            for p in self.image_files]

    def __getitem__(self, i):
        img = _resize_image(_chw(_img01(self.image_files[i])), (480, 640))
        depth = np.asarray(Image.open(self.depth_files[i])).astype(
            np.float32) / 1000.0
        return self._sample(img, depth, self.image_files[i])


class DIMLOutdoor(_Reader):
    """diml_outdoor_test.py:78-110: ``<scene>/outleft/*.png`` with
    ``depthmap`` uint16 (mm -> m); native resolution."""
    name = "diml_outdoor"

    def __init__(self, root: str):
        self.image_files = sorted(glob.glob(
            os.path.join(root, "*", "outleft", "*.png")))
        self.depth_files = [p.replace("outleft", "depthmap")
                            for p in self.image_files]

    def __getitem__(self, i):
        depth = np.asarray(Image.open(self.depth_files[i])).astype(
            np.float32) / 1000.0
        return self._sample(_chw(_img01(self.image_files[i])), depth,
                            self.image_files[i])


class Ibims(_Reader):
    """ibims.py:34-74: ``imagelist.txt`` basenames; depth uint16 * 50/65535;
    pixels outside (mask_invalid * mask_transp) get the -1 sentinel."""
    name = "ibims"

    def __init__(self, root: str):
        with open(os.path.join(root, "imagelist.txt")) as f:
            names = f.read().split()
        self.root = root
        self.image_files = [os.path.join(root, "rgb", n + ".png")
                            for n in names]
        self.names = names

    def __getitem__(self, i):
        n = self.names[i]
        depth = np.asarray(Image.open(
            os.path.join(self.root, "depth", n + ".png")),
            np.uint16).astype(np.float64) * 50.0 / 65535
        valid = np.asarray(Image.open(
            os.path.join(self.root, "mask_invalid", n + ".png")))
        transp = np.asarray(Image.open(
            os.path.join(self.root, "mask_transp", n + ".png")))
        depth = np.where(valid * transp, depth, -1).astype(np.float32)
        return self._sample(_chw(_img01(self.image_files[i])), depth,
                            self.image_files[i])


class SunRGBD(_Reader):
    """sun_rgbd_loader.py:78-100: ``rgb/rgb/*`` images, ``gt/gt`` uint16
    png depths (mm -> m)."""
    name = "sunrgbd"

    def __init__(self, root: str):
        self.image_files = sorted(glob.glob(os.path.join(root, "rgb", "rgb", "*")))
        self.depth_files = [p.replace("rgb/rgb", "gt/gt").replace("jpg", "png")
                            for p in self.image_files]

    def __getitem__(self, i):
        depth = np.asarray(Image.open(self.depth_files[i]),
                           np.uint16).astype(np.float32) / 1000.0
        return self._sample(_chw(_img01(self.image_files[i])), depth,
                            self.image_files[i])


class Diode(_Reader):
    """diode.py:82-116: ``<scene>/<scan>/*.png`` with ``*_depth.npy`` (m)
    and ``*_depth_mask.npy`` validity; image resized shorter-side 480."""
    name = "diode"

    def __init__(self, root: str):
        self.image_files = sorted(glob.glob(os.path.join(root, "*", "*", "*.png")))
        self.depth_files = [p.replace(".png", "_depth.npy")
                            for p in self.image_files]
        self.mask_files = [p.replace(".png", "_depth_mask.npy")
                           for p in self.image_files]

    def __getitem__(self, i):
        img = _resize_image(_chw(_img01(self.image_files[i])), 480)
        depth = np.load(self.depth_files[i]).astype(np.float32).squeeze()
        valid = np.load(self.mask_files[i])
        s = self._sample(img, depth, self.image_files[i])
        s["valid"] = valid
        return s


class HyperSim(_Reader):
    """hypersim.py:36-130: tonemapped previews + hdf5 Euclidean distances
    converted to planar depth (focal 886.81 @ 1024x768); image 480x640."""
    name = "hypersim_test"

    def __init__(self, root: str):
        self.image_files = sorted(glob.glob(os.path.join(
            root, "*", "images", "scene_cam_*_final_preview",
            "*.tonemap.jpg")))
        self.depth_files = [p.replace("_final_preview", "_geometry_hdf5")
                             .replace(".tonemap.jpg", ".depth_meters.hdf5")
                            for p in self.image_files]

    @staticmethod
    def distance_to_depth(dist: np.ndarray) -> np.ndarray:
        """Euclidean ray length -> planar depth (hypersim.py:36-48)."""
        w, h, focal = 1024, 768, 886.81
        xs = np.linspace(-0.5 * w + 0.5, 0.5 * w - 0.5, w,
                         dtype=np.float32)[None, :, None].repeat(h, 0)
        ys = np.linspace(-0.5 * h + 0.5, 0.5 * h - 0.5, h,
                         dtype=np.float32)[:, None, None].repeat(w, 1)
        zs = np.full((h, w, 1), focal, np.float32)
        plane = np.concatenate([xs, ys, zs], 2)
        return dist / np.linalg.norm(plane, 2, 2) * focal

    def __getitem__(self, i):
        import h5py

        img = _resize_image(_chw(_img01(self.image_files[i])), (480, 640))
        with h5py.File(self.depth_files[i], "r") as fd:
            dist = np.asarray(fd["dataset"])
        depth = self.distance_to_depth(dist).astype(np.float32)
        return self._sample(img, depth, self.image_files[i])


class VKitti(_Reader):
    """vkitti.py:82-130: ``test_color/*.png`` with ``test_depth`` 16-bit
    pngs read RAW (the reference applies no cm->m conversion and its
    kb-crop branch is disabled with ``and False`` — both quirks kept)."""
    name = "vkitti"

    def __init__(self, root: str):
        self.image_files = sorted(glob.glob(
            os.path.join(root, "test_color", "*.png")))
        self.depth_files = [p.replace("test_color", "test_depth")
                            for p in self.image_files]

    def __getitem__(self, i):
        depth = np.asarray(Image.open(self.depth_files[i])).astype(np.float32)
        return self._sample(_chw(_img01(self.image_files[i])), depth,
                            self.image_files[i])


class VKitti2(_Reader):
    """vkitti2.py:83-160: recursive ``rgb/**/frames/rgb/Camera_0/*.jpg``;
    depth = 16-bit png / 100 (cm -> m); REAL kb-crop to 352x1216; depth > 80
    -> -1; a per-scene 92/8 train/test split file is created on first use
    (the reference shuffles with the global ``random`` module — here a
    seeded numpy Generator, recorded in the split file itself)."""
    name = "vkitti2"

    def __init__(self, root: str, split: str = "test", seed: int = 0):
        self.root = root
        files = sorted(glob.glob(os.path.join(
            root, "rgb", "**", "frames", "rgb", "Camera_0", "*.jpg"),
            recursive=True))
        split_path = os.path.join(root, f"{split}.txt")
        if not os.path.exists(split_path):
            rng = np.random.default_rng(seed)
            scenes = sorted({self._scene(f) for f in files})
            train, test = [], []
            for scene in scenes:
                sf = [f for f in files if self._scene(f) == scene]
                rng.shuffle(sf)
                cut = int(len(sf) * 0.92)
                train.extend(sf[:cut])
                test.extend(sf[cut:])
            with open(os.path.join(root, "train.txt"), "w") as f:
                f.write("\n".join(train))
            with open(os.path.join(root, "test.txt"), "w") as f:
                f.write("\n".join(test))
        with open(split_path) as f:
            self.image_files = f.read().splitlines()
        self.depth_files = [p.replace("/rgb/", "/depth/")
                             .replace("rgb_", "depth_").replace(".jpg", ".png")
                            for p in self.image_files]

    @staticmethod
    def _scene(path: str) -> str:
        # reference quirk kept (vkitti2.py:99-101): three dirnames up from
        # .../<scene>/<variant>/frames/rgb/Camera_0/rgb_x.jpg lands on
        # "frames" for EVERY file, so the "per-scene" split is effectively
        # one global 92/8 split — reproduced, not fixed
        return os.path.basename(os.path.dirname(
            os.path.dirname(os.path.dirname(path))))

    def __getitem__(self, i):
        image = Image.open(self.image_files[i])
        depth_raw = np.asarray(Image.open(self.depth_files[i])).astype(
            np.float32) / 100.0
        depth = Image.fromarray(depth_raw)
        # kb crop (vkitti2.py:141-151)
        top = int(image.height - 352)
        left = int((image.width - 1216) / 2)
        box = (left, top, left + 1216, top + 352)
        image, depth = image.crop(box), depth.crop(box)
        depth = np.array(depth, np.float32)
        depth[depth > 80] = -1
        img = np.asarray(image, np.float32) / 255.0
        return self._sample(_chw(img), depth, self.image_files[i])


class DDAD(_Reader):
    """ddad.py:82-113: flat ``*_rgb.png`` with ``*_depth.npy`` (m); image
    resized to (352, 1216) like ``get_ddad_loader``'s default."""
    name = "ddad"

    def __init__(self, root: str, resize_shape=(352, 1216)):
        self.image_files = sorted(glob.glob(os.path.join(root, "*.png")))
        self.depth_files = [p.replace("_rgb.png", "_depth.npy")
                            for p in self.image_files]
        self.resize_shape = tuple(resize_shape)

    def __getitem__(self, i):
        img = _resize_image(_chw(_img01(self.image_files[i])),
                            self.resize_shape)
        depth = np.load(self.depth_files[i]).astype(np.float32).squeeze()
        return self._sample(img, depth, self.image_files[i])


EVAL_READERS = {
    "diml_indoor": DIMLIndoor,
    "diml_outdoor": DIMLOutdoor,
    "ibims": Ibims,
    "sunrgbd": SunRGBD,
    "diode_indoor": Diode,
    "diode_outdoor": Diode,
    "hypersim_test": HyperSim,
    "vkitti": VKitti,
    "vkitti2": VKitti2,
    "ddad": DDAD,
}


def get_eval_reader(name: str, root: str):
    """Reader instance for a named eval dataset (the dispatch of the
    reference's ``DepthDataLoader.__init__`` special cases,
    data_mono.py:84-126)."""
    return EVAL_READERS[name](root)
