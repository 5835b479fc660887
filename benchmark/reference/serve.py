"""Plain reference of the served path's input: JPEG bytes -> RGB -> the
reference eval transform (shorter side resized to `res` with nearest
neighbour, as torchvision's `Resize` is called there, a centre crop of
res x res, /255, ImageNet normalization) -> [3, res, res] float32.
Imports nothing but numpy, PIL and torch."""

from __future__ import annotations

import io

import numpy as np
import torch
from PIL import Image

MEAN = np.array([0.485, 0.456, 0.406], np.float32)[:, None, None]
STD = np.array([0.229, 0.224, 0.225], np.float32)[:, None, None]


def decode(body: bytes, res: int) -> torch.Tensor:
    img = Image.open(io.BytesIO(body)).convert("RGB")
    w, h = img.size
    if min(w, h) != res:
        ow, oh = (res, int(res * h / w)) if w < h else (int(res * w / h), res)
        img = img.resize((ow, oh), Image.NEAREST)
    w, h = img.size
    left, top = int(round((w - res) / 2.0)), int(round((h - res) / 2.0))
    img = img.crop((left, top, left + res, top + res))
    arr = np.asarray(img).astype(np.float32).transpose(2, 0, 1) / 255.0
    return torch.from_numpy(np.ascontiguousarray((arr - MEAN) / STD))
