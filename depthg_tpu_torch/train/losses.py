"""Contrastive feature-correlation losses, STEGO's plus the DepthG terms
(``depthg_tpu/train/losses.py``).

* Every random draw (coordinates, salience picks, the negatives'
  permutations) comes from the ``torch.Generator`` the caller passes, on
  its device. ``coords_override=`` and ``neg_perms=`` bypass the draws, so a
  parity run needs no random stream to match.
* Coordinate selection (random / uniform pixel / depth FPS / salience)
  stays on the device; both images' FPS run as one [2B] scan.
* The negatives are a loop over the permutations: ``corr_helper``'s
  pointwise centering takes means per call, so folding them into one batch
  would be a different loss.
* Under a process group (``parallel.dist``) each rank holds its rows of
  the global batch and the loss is the single-process one: every
  batch-shaped draw is made at the global batch and sharded, the
  negatives' permutations run over the global batch and read the
  gathered (autograd-aware) features and codes, and the pointwise means
  are all-reduced. ``coords_override`` and ``neg_perms`` are global.

The sampled coordinate tensors are [B, S, S, 2] with S = ``feature_samples``
from the decay schedule.
"""

from __future__ import annotations

import dataclasses

import torch

from depthg_tpu_torch.ops.correlation import norm, tensor_correlation
from depthg_tpu_torch.ops.depth import farthest_point_sampling_depth, uniform_pixel_coords
from depthg_tpu_torch.ops.resize import resize_bilinear
from depthg_tpu_torch.ops.sampling import random_coords, sample, super_perm
from depthg_tpu_torch.parallel import dist


@dataclasses.dataclass(frozen=True)
class CorrLossConfig:
    feature_samples: int = 11
    neg_samples: int = 5
    pos_intra_shift: float = 0.08
    pos_inter_shift: float = 0.02
    neg_inter_shift: float = 0.66
    depth_feat_shift: float = 0.0
    pointwise: bool = True
    zero_clamp: bool = True
    stabalize: bool = False  # sic, the reference's spelling
    depth_sampling: str = "fps"  # "fps" | "simple" | "none" | "fps_depth_feat"
    depth_feat_correlation_loss: bool = True
    use_salience: bool = False

    @property
    def min_val(self) -> float:
        return 0.0 if self.zero_clamp else -9999.0


def from_cfg(cfg) -> CorrLossConfig:
    return CorrLossConfig(
        feature_samples=int(cfg.feature_samples),
        neg_samples=int(cfg.neg_samples),
        pos_intra_shift=float(cfg.pos_intra_shift),
        pos_inter_shift=float(cfg.pos_inter_shift),
        neg_inter_shift=float(cfg.neg_inter_shift),
        depth_feat_shift=float(cfg.depth_feat_shift),
        pointwise=bool(cfg.pointwise),
        zero_clamp=bool(cfg.zero_clamp),
        stabalize=bool(cfg.stabalize),
        depth_sampling=str(cfg.depth_sampling),
        depth_feat_correlation_loss=bool(cfg.depth_feat_correlation_loss),
        use_salience=bool(cfg.use_salience),
    )


def _clamped(lcfg: CorrLossConfig, cd: torch.Tensor) -> torch.Tensor:
    return cd.clamp(lcfg.min_val, 0.8) if lcfg.stabalize else cd.clamp_min(lcfg.min_val)


def corr_helper(lcfg: CorrLossConfig, f1, f2, c1, c2, shift: float):
    """loss = -clamp(code_corr) * (feat_corr - shift), the feature side
    without gradient, including the reference's pointwise mean-centering."""
    with torch.no_grad():
        fd = tensor_correlation(norm(f1), norm(f2))
        if lcfg.pointwise:
            old_mean = dist.mean(fd.mean())
            fd = fd - fd.mean(dim=(3, 4), keepdim=True)
            fd = fd - dist.mean(fd.mean()) + old_mean
    cd = tensor_correlation(norm(c1), norm(c2))
    return -_clamped(lcfg, cd) * (fd - shift), cd


def depth_feature_correlation(lcfg: CorrLossConfig, c1, c2, d1, d2, shift):
    """The depth-code correlation term. The depth maps are resized
    (bilinear, align_corners=True) to the sampled code grid and
    channel-normalized; with one channel that leaves depth's sign pattern,
    which is the reference's behaviour and kept deliberately."""
    cd = tensor_correlation(norm(c1), norm(c2))
    with torch.no_grad():
        d1 = resize_bilinear(d1, c1.shape[2:], align_corners=True)
        d2 = resize_bilinear(d2, c2.shape[2:], align_corners=True)
        dd = tensor_correlation(norm(d1), norm(d2))
    return -_clamped(lcfg, cd) * (dd - shift), dd


def _salience_coords(salience: torch.Tensor, coord_shape,
                     generator: torch.Generator) -> torch.Tensor:
    """Uniform draw over the nonzero entries of the salience map (over all
    pixels where it is empty), with the reference's normalize-by-H and flip
    quirks."""
    b, s1, s2, _ = coord_shape
    h, w = salience.shape[-2:]
    nonzero = salience.reshape(b, h * w) > 0
    weights = dist.all_gather((nonzero | ~nonzero.any(dim=1, keepdim=True)).float())
    idx = dist.shard_rows(torch.multinomial(weights, s1 * s2, replacement=True,
                                            generator=generator))
    rows = torch.div(idx, w, rounding_mode="floor").float()
    cols = (idx % w).float()
    coords = torch.stack([rows, cols], dim=-1).reshape(b, s1, s2, 2)
    coords = coords / h * 2 - 1  # the reference divides both axes by H
    return coords.flip(-1)


def select_coords(lcfg: CorrLossConfig, feats, feats_pos, depth, depth_pos,
                  salience=None, salience_pos=None,
                  generator: torch.Generator | None = None):
    """The two coordinate grids of the reference ``forward``, in [-1, 1]."""
    b = feats.shape[0]
    s = lcfg.feature_samples
    coord_shape = (b, s, s, 2)

    if lcfg.use_salience:
        c1_nz = _salience_coords(salience, coord_shape, generator)
        c2_nz = _salience_coords(salience_pos, coord_shape, generator)
        c1_reg = _random_coords(coord_shape, generator)
        c2_reg = _random_coords(coord_shape, generator)
        mask = (dist.draw_rows(lambda n: torch.rand((n, s, s), generator=generator,
                                                    device=generator.device), b)
                > 0.1)[..., None].float()
        return c1_nz * mask + c1_reg * (1 - mask), c2_nz * mask + c2_reg * (1 - mask)
    if lcfg.depth_sampling == "simple":
        hw = tuple(feats.shape[-2:])
        return tuple(dist.draw_rows(lambda n: uniform_pixel_coords(n, s, hw, generator), b)
                     * 2 - 1 for _ in range(2))
    if lcfg.depth_sampling in ("fps", "fps_depth_feat"):
        # "fps_depth_feat" behaves like "fps": the reference passes
        # include_feats=True to a sampler that ignores it. Both images' FPS
        # run as one batched scan.
        both = farthest_point_sampling_depth(
            torch.cat([feats, feats_pos]), torch.cat([depth, depth_pos]), s) * 2 - 1
        return both[:b], both[b:]
    return _random_coords(coord_shape, generator), _random_coords(coord_shape, generator)


def _random_coords(shape, generator):
    """``random_coords`` drawn at the global batch, this rank's rows."""
    return dist.draw_rows(lambda n: random_coords((n, *shape[1:]), generator), shape[0])


def _negatives(lcfg, orig_feats, orig_code, feats, code, coords2, neg_perms, generator):
    """The negatives' (losses, cds, perms), each helper call with its own
    means: [neg, B, S, S, S, S] twice and [neg, B] (the global batch's
    permutations; this rank's columns index the gathered rows)."""
    if neg_perms is None:
        neg_perms = torch.stack([super_perm(orig_feats.shape[0] * dist.world(), generator)
                                 for _ in range(lcfg.neg_samples)])
    all_feats, all_code = dist.all_gather(orig_feats), dist.all_gather(orig_code)
    start, stop = dist.shard_range(neg_perms.shape[1])
    losses, cds = [], []
    for perm in neg_perms[:, start:stop]:
        feats_neg = sample(all_feats[perm], coords2)
        code_neg = sample(all_code[perm], coords2)
        loss, cd = corr_helper(lcfg, feats, feats_neg, code, code_neg,
                               lcfg.neg_inter_shift)
        losses.append(loss)
        cds.append(cd)
    return torch.stack(losses), torch.stack(cds), neg_perms


def contrastive_correlation_loss(lcfg: CorrLossConfig,
                                 orig_feats, orig_feats_pos,
                                 orig_code, orig_code_pos,
                                 depth=None, depth_pos=None,
                                 salience=None, salience_pos=None,
                                 coords_override=None, neg_perms=None,
                                 depth_feat_shift=None,
                                 generator: torch.Generator | None = None):
    """The full DepthG contrastive loss: a dict of losses and correlations.

    ``coords_override=(coords1, coords2)`` bypasses the sampling and
    ``neg_perms`` ([neg, B] long) the permutation draws (parity tests).
    ``depth_feat_shift`` (the decay schedule's value) defaults to the
    config's."""
    if coords_override is not None:
        coords1, coords2 = (dist.shard_rows(c) for c in coords_override)
    else:
        coords1, coords2 = select_coords(lcfg, orig_feats, orig_feats_pos, depth,
                                         depth_pos, salience, salience_pos, generator)

    feats = sample(orig_feats, coords1)
    code = sample(orig_code, coords1)
    feats_pos = sample(orig_feats_pos, coords2)
    code_pos = sample(orig_code_pos, coords2)

    pos_intra_loss, pos_intra_cd = corr_helper(lcfg, feats, feats, code, code,
                                               lcfg.pos_intra_shift)
    pos_inter_loss, pos_inter_cd = corr_helper(lcfg, feats, feats_pos, code, code_pos,
                                               lcfg.pos_inter_shift)
    out = {
        "pos_intra_loss": pos_intra_loss.mean(),
        "pos_intra_cd": pos_intra_cd,
        "pos_inter_loss": pos_inter_loss.mean(),
        "pos_inter_cd": pos_inter_cd,
    }

    if lcfg.depth_feat_correlation_loss:
        shift = lcfg.depth_feat_shift if depth_feat_shift is None else depth_feat_shift
        df_loss, df_cd = depth_feature_correlation(lcfg, code, code, depth, depth, shift)
        out["depth_feat_loss"] = df_loss.mean()
        out["depth_feat_cd"] = df_cd

    neg_losses, neg_cds, perms = _negatives(lcfg, orig_feats, orig_code, feats, code,
                                            coords2, neg_perms, generator)
    out["neg_inter_loss"] = neg_losses  # [neg, B, S, S, S, S]; the caller means
    out["neg_inter_cd"] = neg_cds
    out["neg_perms"] = perms
    out["coords"] = (coords1, coords2)
    return out


def depth_contrastive_correlation_loss(lcfg: CorrLossConfig,
                                       orig_feats, orig_feats_pos,
                                       orig_code, orig_code_pos,
                                       depth_aug_feats, depth_aug_feats_pos,
                                       salience=None, salience_pos=None,
                                       coords_override=None, neg_perms=None,
                                       generator: torch.Generator | None = None):
    """The ``use_depth_only_intra`` variant: pos_intra runs on the
    depth-augmented feats; coordinates are random or salience only."""
    if coords_override is not None:
        coords1, coords2 = (dist.shard_rows(c) for c in coords_override)
    else:
        rand_cfg = dataclasses.replace(lcfg, depth_sampling="none")
        coords1, coords2 = select_coords(rand_cfg, orig_feats, orig_feats_pos,
                                         None, None, salience, salience_pos, generator)

    feats = sample(orig_feats, coords1)
    code = sample(orig_code, coords1)
    feats_pos = sample(orig_feats_pos, coords2)
    code_pos = sample(orig_code_pos, coords2)
    d_feats = sample(depth_aug_feats, coords1)

    pos_intra_loss, pos_intra_cd = corr_helper(lcfg, d_feats, d_feats, code, code,
                                               lcfg.pos_intra_shift)
    pos_inter_loss, pos_inter_cd = corr_helper(lcfg, feats, feats_pos, code, code_pos,
                                               lcfg.pos_inter_shift)
    neg_losses, neg_cds, _ = _negatives(lcfg, orig_feats, orig_code, feats, code,
                                        coords2, neg_perms, generator)
    return {
        "pos_intra_loss": pos_intra_loss.mean(),
        "pos_intra_cd": pos_intra_cd,
        "pos_inter_loss": pos_inter_loss.mean(),
        "pos_inter_cd": pos_inter_cd,
        "neg_inter_loss": neg_losses,
        "neg_inter_cd": neg_cds,
    }


def intra_depth_feature_diversity_loss(feats, depth):
    """The reference's ``IntraDepthFeatureDiversityLoss``
    (``src/modules.py:1466-1471``) is an empty stub whose forward returns
    None; kept for the inventory, as the JAX package keeps it."""
    return None


def contrastive_crf_loss(guidance, clusters, n_samples: int,
                         alpha: float, beta: float, gamma: float,
                         w1: float, w2: float, shift: float,
                         generator: torch.Generator | None = None, coords=None):
    """The training-time CRF regularizer: one coordinate set shared by the
    batch, an RGB+XY Gaussian kernel against the clusters' self-similarity.
    ``coords=(rows, cols)`` (long, [n]) bypasses the draw."""
    h, w = guidance.shape[-2:]
    if coords is None:
        coords = (torch.randint(0, h, (n_samples,), generator=generator,
                                device=generator.device),
                  torch.randint(0, w, (n_samples,), generator=generator,
                                device=generator.device))
    coords_r, coords_c = coords

    flat_idx = coords_r * w + coords_c
    sel_g = guidance.flatten(2)[:, :, flat_idx]  # [B, C, n]
    sel_k = clusters.flatten(2)[:, :, flat_idx]

    xy = torch.stack([coords_r, coords_c]).float()  # [2, n]
    coord_diff = (xy[:, :, None] - xy[:, None, :]).square().sum(0)[None]
    guidance_diff = (sel_g[:, :, :, None] - sel_g[:, :, None, :]).square().sum(1)

    sim_kernel = (w1 * torch.exp(-coord_diff / (2 * alpha) - guidance_diff / (2 * beta))
                  + w2 * torch.exp(-coord_diff / (2 * gamma)) - shift)
    cluster_sims = torch.einsum("nka,nkb->nab", sel_k, sel_k)
    return -(cluster_sims * sim_kernel)
