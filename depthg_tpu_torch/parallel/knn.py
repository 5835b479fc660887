"""Dataset-wide cosine-similarity KNN (``depthg_tpu/parallel/knn.py``; the
chunked loop of reference ``src/precompute_knns.py:101-113``).

The N x N similarity is never materialized: query rows go through the device
in chunks of 1024 against the key matrix, keeping only the top-k. Above
``2 * _KEY_BLOCK`` keys the keys go in blocks of 65,536 rows as well, so the
largest temporary is one [1024, 65,536] float32 block (268 MB; a
[1024, N] row of blocks would be 9.7 GB at the cocostuff five-crop N ~ 590k);
the per-block top-k candidates are merged by a final top-k over their
columns, which is exact (the global top-k is a subset of the per-block
top-ks). The similarity product and the top-k are ``torch.matmul`` and
``torch.topk``: the JAX package computes them outside any Pallas kernel too.

With a process ``group`` (``parallel.dist``; the JAX package's ``mesh``)
the query rows are split over the ranks, each rank holding every key, and
the index rows are all-gathered: every rank returns the whole [N, k]
array, equal to the single process's. The queries are padded with zero
rows to a multiple of the world; their rows are dropped, and the keys are
never padded.
"""

from __future__ import annotations

import numpy as np
import torch

from depthg_tpu_torch.models.featurizer import backbone_features
from depthg_tpu_torch.models.pyramid import FrozenBackbone, feature_map
from depthg_tpu_torch.ops.correlation import norm
from depthg_tpu_torch.parallel import dist
from depthg_tpu_torch.runtime import get_device

# keys are processed in blocks of this many rows (see the module docstring)
_KEY_BLOCK = 65536


def pooled_features(net, img: torch.Tensor, precision: str | None = None) -> torch.Tensor:
    """Global image embedding [B, C]: mean-pooled dense features of the
    frozen backbone of ``net`` (a ``DinoFeaturizer``, or a CNN backbone of
    ``models.pyramid.load_model``: its map before pooling), L2-normalized
    (reference ``get_feats``, ``src/precompute_knns.py:15-21``). float32
    throughout, as the JAX function."""
    if isinstance(net, FrozenBackbone):
        with torch.no_grad():
            feats = feature_map(net, img)
    else:
        feats, _ = backbone_features(net, img, precision)
    return norm(feats.mean(dim=(2, 3)), dim=1)


def topk_neighbors(feats, k: int = 30, chunk: int = 1024, group=None,
                   precision: str | None = None,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """Top-k cosine neighbors for every row of ``feats`` [N, C] (normalized;
    numpy or torch), self included: [N, k] int32 numpy, the dtype the JAX
    package writes into ``nns_*.npz``. Runs on ``device``; with a process
    ``group`` every rank passes the same ``feats`` and computes the top-k of
    its share of the query rows.

    ``precision``: "highest" is a float32 product (TF32 stays off), for
    index-exact parity with a float32 reference. None is the JAX default on
    the TPU, a bf16 multiply with float32 accumulation (fine for training,
    where a random neighbor of rank 1..k is drawn anyway): on CUDA the
    operands are rounded to bf16 and ``torch.mm(..., out_dtype=float32)``
    returns the float32 sums, so near-ties do not collapse into bf16 ties
    before the top-k; on the CPU, where that product does not exist, None is
    the float32 product too. Equal similarities come in ``torch.topk``'s
    order, which is not specified."""
    if group is not None and not dist.active():
        raise ValueError("topk_neighbors(group=...) needs a process group "
                         "(parallel.dist.init_from_env)")
    if precision not in (None, "highest"):
        raise ValueError(f"precision must be None or 'highest', got {precision!r}")
    dev = get_device(device)
    if not isinstance(feats, torch.Tensor):
        feats = torch.from_numpy(np.ascontiguousarray(feats, np.float32))
    keys = feats.to(dev, torch.float32)
    if precision is None and dev.type == "cuda":
        keys = keys.to(torch.bfloat16)
    with torch.inference_mode():
        if group is None:
            return _topk_inner(keys, keys, k, chunk).cpu().numpy()
        n, w = keys.shape[0], torch.distributed.get_world_size(group)
        per = -(-n // w)
        r = torch.distributed.get_rank(group)
        queries = keys[r * per:(r + 1) * per]
        if queries.shape[0] < per:
            queries = torch.cat([queries, queries.new_zeros(
                (per - queries.shape[0], keys.shape[1]))])
        idx = dist.all_gather(_topk_inner(queries, keys, k, chunk), group)
        return idx[:n].cpu().numpy()


def _similarities(qb: torch.Tensor, kb: torch.Tensor, base: int,
                  mask_from: int | None) -> torch.Tensor:
    """float32 [q, n] similarities with key columns >= ``mask_from`` forced
    to -inf (zero-padded key rows must never win the top-k: their cosine
    similarity of exactly 0 outranks negative real ones)."""
    if qb.dtype == torch.bfloat16:
        sims = torch.mm(qb, kb.t(), out_dtype=torch.float32)
    else:
        sims = qb @ kb.t()
    if mask_from is not None and base + kb.shape[0] > mask_from:
        col = base + torch.arange(kb.shape[0], device=kb.device)
        sims = sims.masked_fill(col >= mask_from, float("-inf"))
    return sims


def _topk_inner(queries: torch.Tensor, keys: torch.Tensor, k: int, chunk: int,
                valid_n: int | None = None) -> torch.Tensor:
    """[nq, k] int32 indices into ``keys`` of each query row's k most similar
    keys; keys at ``valid_n`` and beyond (padding) are never returned."""
    nq, n_keys = queries.shape[0], keys.shape[0]
    out = torch.empty((nq, k), dtype=torch.int32, device=queries.device)
    for start in range(0, nq, chunk):
        qb = queries[start:start + chunk]
        if n_keys <= 2 * _KEY_BLOCK:
            idx = _similarities(qb, keys, 0, valid_n).topk(k, dim=1).indices
        else:
            vals, idxs = [], []
            for base in range(0, n_keys, _KEY_BLOCK):
                kb = keys[base:base + _KEY_BLOCK]
                v, i = _similarities(qb, kb, base, valid_n).topk(
                    min(k, kb.shape[0]), dim=1)
                vals.append(v)
                idxs.append(i + base)
            # [chunk, nb*k] candidates; their top-k is the exact global top-k
            sel = torch.cat(vals, dim=1).topk(k, dim=1).indices
            idx = torch.cat(idxs, dim=1).gather(1, sel)
        out[start:start + chunk] = idx
    return out
