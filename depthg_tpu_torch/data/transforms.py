"""Host-side image transforms (PIL + numpy), matching the reference pipeline.

Reference semantics (``src/utils.py:139-182``):
* ``Resize(res, Image.NEAREST)`` — shorter side to ``res``, aspect preserved
  (note: NEAREST for *both* image and label, a deliberate reference quirk);
* center or random crop to ``res`` x ``res`` (crop_type None = resize to the
  exact square instead);
* images -> float32 [3, H, W] in [0, 1], ImageNet-normalized; labels ->
  int64 [H, W]; depth PNGs -> float32 [1, H, W] in [0, 1] (8-bit) or raw/1e4
  (16-bit, handled by the datasets).

Instead of the reference's global-seed synchronization trick
(``random.seed(seed); torch.manual_seed(seed)`` before each of img/label —
``src/data.py:116-124``), paired transforms draw their crop offsets from one
explicit ``np.random.Generator`` snapshot shared across image/label/depth.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from PIL import Image, ImageFilter

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resize_shorter(img: Image.Image, size, resample=Image.NEAREST) -> Image.Image:
    """torchvision Resize semantics: int size -> shorter side; tuple -> exact."""
    if isinstance(size, (tuple, list)):
        return img.resize((size[1], size[0]), resample)
    w, h = img.size
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        ow, oh = size, int(size * h / w)
    else:
        oh, ow = size, int(size * w / h)
    return img.resize((ow, oh), resample)


def _pad_to(img: Image.Image, tw: int, th: int) -> Image.Image:
    w, h = img.size
    if w >= tw and h >= th:
        return img
    out = Image.new(img.mode, (max(w, tw), max(h, th)))
    out.paste(img, ((max(w, tw) - w) // 2, (max(h, th) - h) // 2))
    return out


def center_crop(img: Image.Image, size: int) -> Image.Image:
    img = _pad_to(img, size, size)
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def random_crop(img: Image.Image, size: int, top: int, left: int) -> Image.Image:
    img = _pad_to(img, size, size)
    return img.crop((left, top, left + size, top + size))


def image_to_array(img: Image.Image) -> np.ndarray:
    """PIL -> float32 [C, H, W] scaled to [0, 1] (torchvision ToTensor)."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / 65535.0
    else:
        arr = arr.astype(np.float32)
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def normalize_array(arr: np.ndarray) -> np.ndarray:
    """ImageNet normalization on [3, H, W]."""
    return (arr - IMAGENET_MEAN[:, None, None]) / IMAGENET_STD[:, None, None]


def unnormalize(arr) -> "np.ndarray":
    """Inverse of normalize_array; works on numpy [.., 3, H, W]."""
    mean = IMAGENET_MEAN[:, None, None]
    std = IMAGENET_STD[:, None, None]
    return arr * std + mean


def label_to_array(img: Image.Image) -> np.ndarray:
    """PIL label -> int64 [H, W] (reference ``ToTargetTensor`` minus the
    leading channel axis, which we re-add where the reference keeps it)."""
    return np.asarray(img).astype(np.int64)


@dataclasses.dataclass
class Transform:
    """One reference-style transform: resize(NEAREST) + crop + tensorize.

    ``__call__(pil, rng)``: crop randomness comes from ``rng`` so paired
    image/label/depth calls with the same offsets stay aligned — use
    ``crop_params(rng, pil)`` + ``apply(pil, params)`` for explicit pairing.
    """

    res: int
    is_label: bool
    crop_type: str | None  # "center" | "random" | None
    normalize: bool = True

    def _target_size(self):
        return (self.res, self.res) if self.crop_type is None else self.res

    def crop_params(self, pil: Image.Image, rng: np.random.Generator):
        if self.crop_type != "random":
            return (0, 0)
        resized = resize_shorter(pil, self._target_size())
        w, h = max(resized.size[0], self.res), max(resized.size[1], self.res)
        top = int(rng.integers(0, h - self.res + 1))
        left = int(rng.integers(0, w - self.res + 1))
        return (top, left)

    def apply(self, pil: Image.Image, params=(0, 0)) -> np.ndarray:
        pil = resize_shorter(pil, self._target_size())
        if self.crop_type == "center":
            pil = center_crop(pil, self.res)
        elif self.crop_type == "random":
            pil = random_crop(pil, self.res, *params)
        if self.is_label:
            return label_to_array(pil)
        arr = image_to_array(pil)
        if self.normalize and arr.shape[0] == 3:
            arr = normalize_array(arr)
        return arr

    def __call__(self, pil: Image.Image, rng: np.random.Generator | None = None):
        params = self.crop_params(pil, rng) if rng is not None else (0, 0)
        return self.apply(pil, params)


def get_transform(res: int, is_label: bool, crop_type: str | None) -> Transform:
    if crop_type not in ("center", "random", None):
        raise ValueError(f"Unknown cropper {crop_type}")
    return Transform(res=res, is_label=is_label, crop_type=crop_type)


@dataclasses.dataclass
class RawTransform:
    """Tensorize only — no resize/crop/normalize. Used by ``crop_datasets``
    (the reference passes plain ToTensor/ToTargetTensor there,
    ``src/crop_datasets.py:148-149``)."""

    is_label: bool
    res: int | None = None
    crop_type: str | None = None

    def crop_params(self, pil, rng):
        return (0, 0)

    def apply(self, pil, params=(0, 0)):
        return label_to_array(pil) if self.is_label else image_to_array(pil)

    def __call__(self, pil, rng=None):
        return self.apply(pil)


# ---- photometric / geometric augmentation (train-time aug_alignment path) ----

def random_horizontal_flip(rng, pil):
    return pil.transpose(Image.FLIP_LEFT_RIGHT) if rng.random() < 0.5 else pil


def random_resized_crop_params(rng, w, h, scale=(0.8, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop.get_params sampling scheme."""
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = np.log(ratio)
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    return 0, 0, h, w  # fallback: whole image


def color_jitter(rng, pil, brightness=0.3, contrast=0.3, saturation=0.3, hue=0.1):
    from PIL import ImageEnhance

    ops = []
    if brightness:
        ops.append(("b", rng.uniform(max(0, 1 - brightness), 1 + brightness)))
    if contrast:
        ops.append(("c", rng.uniform(max(0, 1 - contrast), 1 + contrast)))
    if saturation:
        ops.append(("s", rng.uniform(max(0, 1 - saturation), 1 + saturation)))
    if hue:
        ops.append(("h", rng.uniform(-hue, hue)))
    rng.shuffle(ops)
    for kind, f in ops:
        if kind == "b":
            pil = ImageEnhance.Brightness(pil).enhance(f)
        elif kind == "c":
            pil = ImageEnhance.Contrast(pil).enhance(f)
        elif kind == "s":
            pil = ImageEnhance.Color(pil).enhance(f)
        else:
            hsv = np.array(pil.convert("HSV"))
            hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(f * 255)) % 256
            pil = Image.fromarray(hsv, "HSV").convert("RGB")
    return pil


def random_grayscale(rng, pil, p=0.2):
    if rng.random() < p:
        return pil.convert("L").convert("RGB")
    return pil


def random_gaussian_blur(rng, pil, p=0.5, sigma=(0.1, 2.0)):
    if rng.random() < p:
        return pil.filter(ImageFilter.GaussianBlur(rng.uniform(*sigma)))
    return pil


class GeometricAug:
    """Flip + RandomResizedCrop applied identically to the image and the
    [-1,1] coordinate grid (reference ``coord_aug`` pairing,
    ``src/data.py:1132-1139``)."""

    def __init__(self, res: int, scale=(0.8, 1.0)):
        self.res = res
        self.scale = scale

    def sample(self, rng, w, h):
        return {
            "flip": rng.random() < 0.5,
            "crop": random_resized_crop_params(rng, w, h, self.scale),
        }

    def apply_image(self, arr: np.ndarray, params) -> np.ndarray:
        """arr: [C, H, W] float; returns [C, res, res] (bilinear resize)."""
        c, h, w = arr.shape
        if params["flip"]:
            arr = arr[:, :, ::-1]
        top, left, ch, cw = params["crop"]
        patch = arr[:, top:top + ch, left:left + cw]
        imgs = [Image.fromarray(p) for p in patch.astype(np.float32)]
        resized = [np.asarray(im.resize((self.res, self.res), Image.BILINEAR))
                   for im in imgs]
        return np.stack(resized)


class PhotometricAug:
    def __init__(self):
        pass

    def __call__(self, rng, pil: Image.Image) -> Image.Image:
        pil = color_jitter(rng, pil)
        pil = random_grayscale(rng, pil)
        pil = random_gaussian_blur(rng, pil)
        return pil
