"""Synthetic scenes drawn from a seed on the device: piecewise-smooth
images with per-region labels and depth, in a few large calls.

Each image is a Voronoi partition of `regions` random sites. A region
has a base colour, a linear colour gradient, a class label (or -1,
COCO-Stuff's unlabelled, with probability `unlabelled`) and a plane of
depth. Mild pixel noise keeps the CRF's colour kernel from seeing flat
regions only. Every seed draws the same sizes; only the values move.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def scene_batch(gen: torch.Generator, batch: int, res: int, regions: int, n_classes: int,
                unlabelled: float = 0.1, noise: float = 0.02) -> dict:
    """{"img": [B, 3, R, R] ImageNet-normalized float32, "label": [B, R, R]
    int64 in [-1, n_classes), "depth": [B, 1, R, R] in (0, 1]} on the
    generator's device."""
    dev = gen.device
    b, k = batch, regions
    sites = torch.rand((b, k, 2), generator=gen, device=dev)
    colour = torch.rand((b, k, 3), generator=gen, device=dev)
    grad = (torch.rand((b, k, 3, 2), generator=gen, device=dev) - 0.5) * 0.6
    classes = torch.randint(0, n_classes, (b, k), generator=gen, device=dev)
    unl = torch.rand((b, k), generator=gen, device=dev) < unlabelled
    plane = torch.rand((b, k, 3), generator=gen, device=dev)
    pix_noise = torch.randn((b, 3, res, res), generator=gen, device=dev) * noise

    axis = (torch.arange(res, device=dev, dtype=torch.float32) + 0.5) / res
    yy, xx = axis[:, None].expand(res, res), axis[None, :].expand(res, res)
    d2 = (yy[None, None] - sites[..., 0, None, None]) ** 2 \
        + (xx[None, None] - sites[..., 1, None, None]) ** 2  # [B, K, R, R]
    region = d2.argmin(dim=1)  # [B, R, R]
    del d2

    def per_pixel(t):  # [B, K, ...] -> [B, R, R, ...]
        idx = region.reshape(b, -1)
        flat = t.reshape(b, k, -1)
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[-1])) \
            .reshape(b, res, res, *t.shape[2:])

    rel_y = yy[None] - per_pixel(sites[..., 0:1])[..., 0]
    rel_x = xx[None] - per_pixel(sites[..., 1:2])[..., 0]
    g = per_pixel(grad)  # [B, R, R, 3, 2]
    rgb = per_pixel(colour) + g[..., 0] * rel_y[..., None] + g[..., 1] * rel_x[..., None]
    rgb = (rgb.permute(0, 3, 1, 2) + pix_noise).clamp(0.0, 1.0)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=dev)[None, :, None, None]
    label = torch.where(per_pixel(unl[..., None])[..., 0], -1,
                        per_pixel(classes[..., None])[..., 0])
    p = per_pixel(plane)  # [B, R, R, 3]
    depth = (0.1 + 0.6 * p[..., 0] + 0.3 * (p[..., 1] - 0.5) * yy + 0.3 * (p[..., 2] - 0.5) * xx)
    return {"img": ((rgb - mean) / std).contiguous(), "label": label.contiguous(),
            "depth": depth.clamp(0.05, 1.0)[:, None].contiguous()}
