"""Depth-guided sampling: back-projection and farthest-point sampling on the
tensor's device (``depthg_tpu/ops/depth.py``).

FPS is a sequential scan of S*S - 1 steps; every step is a handful of
vectorized ops over [B, P] with no host synchronization, so the whole batch
(both images of a pair, as one [2B] batch) advances together. The scan is
written so that the card and the CPU round alike: the three squared
differences are added in a fixed order, the back-projection factor is a
host constant, and nothing is divided by a Python number (the card would
multiply by the reciprocal).

``depth2points`` keeps the reference's quirk of handing a field of view in
degrees to a ``tan`` that reads radians (factor = 2 tan(90 / 2) with 45 as
radians): sampling geometry follows the reference's training dynamics, not
its intent.
"""

from __future__ import annotations

import math

import torch

from depthg_tpu_torch.ops.resize import adaptive_avg_pool2d


def _depth2points(depth: torch.Tensor, fov: float, far: float) -> torch.Tensor:
    """[..., H, W] depth -> [..., 3, H, W] XYZ."""
    h, w = depth.shape[-2:]
    # fov is in degrees but tan reads it as radians: reference behaviour
    factor = 2.0 * math.tan(fov / 2.0)
    yy = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    xx = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    scaled = factor * depth
    # divisions by tensors: by a Python number the card multiplies by the
    # reciprocal instead, and would round differently from the CPU
    y = scaled * (yy - h / 2.0) / torch.full_like(yy, h)
    x = scaled * (xx - w / 2.0) / torch.full_like(xx, w)
    return torch.stack([x, y, -depth * far], dim=-3)


def depth2points(depth: torch.Tensor, fov: float = 30.0, far: float = 5.0) -> torch.Tensor:
    """Back-project a depth map [H, W] (or [1, H, W]) to XYZ [3, H, W]."""
    if depth.dim() == 3:
        depth = depth[0]
    return _depth2points(depth, fov, far)


def _fps_scan(n_points: int, n_samples: int, device, batch: int, sq_dist_to):
    """The FPS scan shared by the samplers: start at index 0; each step takes
    the not-yet-chosen point with the largest min-distance to the chosen set,
    the first such index on ties (``argmax``). ``sq_dist_to(last [B, 1])``
    gives the [B, P] distances to the last pick. Chosen points are held at
    -inf in the running distances, which ``minimum`` keeps there."""
    dists = torch.full((batch, n_points), float("inf"), device=device)
    dists[:, 0] = float("-inf")
    picks = [torch.zeros(batch, 1, dtype=torch.long, device=device)]
    for _ in range(1, n_samples):
        torch.minimum(dists, sq_dist_to(picks[-1]), out=dists)
        picks.append(dists.argmax(dim=1, keepdim=True))
        dists.scatter_(1, picks[-1], float("-inf"))
    return torch.cat(picks, dim=1)


PAIRWISE_BYTES = 1 << 30  # most memory the all-pairs distances of one scan may take


def _fps_indices_batched(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """points [B, D, P] (coordinate planes) -> indices [B, n_samples].

    The all-pairs squared distances [B, P, P] are built once, the squared
    differences of the planes added in a fixed order (the same sum on every
    device), and a scan step reads one row of them: 4 small launches per
    step, where computing the row in the step took 8 (the scan is bound by
    the host's launch rate). Batches whose table would exceed
    ``PAIRWISE_BYTES`` run in groups of images."""
    points = points.float()
    b, d, p = points.shape
    group = max(1, PAIRWISE_BYTES // (4 * p * p))
    if b > group:
        return torch.cat([_fps_indices_batched(points[i:i + group], n_samples)
                          for i in range(0, b, group)])
    table = None
    for k in range(d):
        diff = points[:, k, :, None] - points[:, k, None, :]
        table = diff * diff if table is None else table + diff * diff
    rows = torch.arange(b, device=points.device)
    return _fps_scan(p, n_samples, points.device, b, lambda last: table[rows, last[:, 0]])


def fps_indices(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Farthest-point sampling over points [P, D] -> indices [n_samples]
    (int64), as the reference host loop: start at 0, ties to the lowest
    index."""
    return _fps_indices_batched(points.t()[None], n_samples)[0]


def farthest_point_sampling_depth(t: torch.Tensor, depth: torch.Tensor,
                                  n_samples: int) -> torch.Tensor:
    """Depth-guided FPS coordinates for a batch.

    t: [B, C, h, w] feature grid (it sets the sampling resolution), depth:
    [B, 1, H, W]; returns [B, S, S, 2] (row, col) in [0, 1): the chosen flat
    indices re-sorted row-major, split and normalized by (h, w). The caller
    maps them to [-1, 1]."""
    h, w = t.shape[-2:]
    depth_small = adaptive_avg_pool2d(depth.float(), (h, w))[:, 0]
    cloud = _depth2points(depth_small, 90.0, 5.0).flatten(2)  # [B, 3, P]
    inds = _fps_indices_batched(cloud, n_samples * n_samples).sort(dim=1).values
    rows = torch.div(inds, w, rounding_mode="floor").float()
    cols = (inds % w).float()
    size = torch.tensor([h, w], dtype=torch.float32, device=inds.device)
    return (torch.stack([rows, cols], dim=-1) / size).reshape(-1, n_samples, n_samples, 2)


def fps_depth_feats_indices(points: torch.Tensor, feats: torch.Tensor,
                            n_samples: int) -> torch.Tensor:
    """Joint depth+feature FPS (the reference's unused ``fps_depth_feats``):
    per step the point and feature distances to the last pick are each
    max-normalized, summed and min-pooled into the running distances.
    points [P, D], feats [P, C] -> indices [n_samples]."""
    points, feats = points.float(), feats.float()

    def sq_dist_to(last):
        dp = (points - points[last[0, 0]]).square().sum(-1)
        df = (feats - feats[last[0, 0]]).square().sum(-1)
        dp = dp / dp.max().clamp_min(1e-20)
        df = df / df.max().clamp_min(1e-20)
        return (dp + df)[None]

    return _fps_scan(points.shape[0], n_samples, points.device, 1, sq_dist_to)[0]


def knn_for_coords(feats: torch.Tensor, coords: torch.Tensor,
                   samples_per_coord: int) -> torch.Tensor:
    """Per-anchor feature-space nearest neighbours with visited-zeroing (the
    reference's unused ``knn_for_coords``). feats: [B, C, H, W], coords:
    [B, S, S, 2] in [0, 1); returns [B, S*S*(1+k), 2] anchor + neighbour
    coordinates."""
    if samples_per_coord <= 0:
        raise ValueError("Not enough samples per coord")
    b, c, h, w = feats.shape
    k = samples_per_coord
    out = []
    for fmap, crds in zip(feats, coords):
        grid = fmap.permute(1, 2, 0).reshape(-1, c).clone()
        flat = crds.reshape(-1, 2)
        anchors = (flat[:, 0] * h).int() * w + (flat[:, 1] * w).int()
        nns = []
        for aidx in anchors:
            d = (grid - grid[aidx]).square().sum(-1).sqrt()
            d = torch.where(d == 0.0, torch.full_like(d, float("inf")), d)
            nn_idx = torch.topk(-d, k + 1).indices
            grid[nn_idx] = 0.0  # visited features are zeroed
            nn_sorted = nn_idx.sort().values
            nns.append(torch.stack([
                torch.div(nn_sorted, w, rounding_mode="floor").float() / h,
                (nn_sorted % w).float() / w], dim=-1))
        out.append(torch.cat([flat, torch.stack(nns).reshape(-1, 2)], dim=0))
    return torch.stack(out)


def uniform_pixel_coords(batch: int, n_samples: int, hw,
                         generator: torch.Generator) -> torch.Tensor:
    """The reference's ``simple_depth_informed_sampling`` (a depth bin drawn
    by its pixel count, then a pixel in it) is a uniform draw over pixels:
    pixel centres, [B, S, S, 2] in (0, 1)."""
    h, w = hw
    shape = (batch, n_samples, n_samples)
    rows = torch.randint(0, h, shape, generator=generator, device=generator.device)
    cols = torch.randint(0, w, shape, generator=generator, device=generator.device)
    return torch.stack([(rows + 0.5) / h, (cols + 0.5) / w], dim=-1).float()
