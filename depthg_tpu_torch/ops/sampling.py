"""Coordinate sampling and gathers of the contrastive correlation loss
(``depthg_tpu/ops/sampling.py``).

``grid_sample`` is ``F.grid_sample(mode="bilinear", padding_mode="border",
align_corners=True)``, the only configuration the reference uses. Every
random draw takes the caller's ``torch.Generator`` and lands on that
generator's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(t: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """t [B, C, H, W], grid [B, Hg, Wg, 2] with (x, y) in [-1, 1] ->
    [B, C, Hg, Wg]."""
    return F.grid_sample(t, grid.to(t.dtype), mode="bilinear",
                         padding_mode="border", align_corners=True)


def sample(t: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The reference ``sample``: transpose the coordinate grid, then
    ``grid_sample``. coords: [B, S, S, 2] in [-1, 1]."""
    return grid_sample(t, coords.permute(0, 2, 1, 3))


def super_perm(size: int, generator: torch.Generator) -> torch.Tensor:
    """Random batch permutation avoiding (most) fixed points."""
    perm = torch.randperm(size, generator=generator, device=generator.device)
    fixed = perm == torch.arange(size, device=perm.device)
    return torch.where(fixed, perm + 1, perm) % size


def random_coords(shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform coordinates in [-1, 1) (``torch.rand(shape) * 2 - 1``)."""
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device) * 2 - 1
