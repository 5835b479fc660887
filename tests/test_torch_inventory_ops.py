"""The inventory ops no pipeline calls, in the PyTorch port vs the JAX
package, on the CPU, with the cases of ``tests/test_inventory_ops.py`` and
``tests/test_resize.py``: ``depth_correlation`` (float32 products in other
orders: 1e-6), ``intra_depth_feature_diversity_loss`` (the reference's
empty stub), ``adaptive_max_pool2d`` (a max: exact), the Hungarian
assignment (exact) and ``SegMetrics.update`` / ``update_cherry`` /
``compute_cherry`` (the same confusion counts and metrics, the cherry
buffer emptied by every compute)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.ops import correlation as jcorr
from depthg_tpu.ops import resize as jresize
from depthg_tpu.train import losses as jlosses
from depthg_tpu.utils import metrics as jmetrics
from depthg_tpu_torch.ops import correlation as tcorr
from depthg_tpu_torch.ops import resize as tresize
from depthg_tpu_torch.train import losses as tlosses
from depthg_tpu_torch.utils import metrics as tmetrics

RNG = np.random.default_rng(11)


def test_depth_correlation_matches_jax():
    a = RNG.random((2, 1, 5, 5)).astype(np.float32)
    b = RNG.random((2, 1, 4, 6)).astype(np.float32)
    ref = np.asarray(jcorr.depth_correlation(jnp.asarray(a), jnp.asarray(b)))
    out = tcorr.depth_correlation(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert out.shape == ref.shape == (2, 5, 5, 4, 6)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_intra_depth_feature_diversity_loss_is_the_reference_stub():
    feats, depth = np.zeros((1, 4, 2, 2), np.float32), np.zeros((1, 1, 2, 2), np.float32)
    assert jlosses.intra_depth_feature_diversity_loss(feats, depth) is None
    assert tlosses.intra_depth_feature_diversity_loss(torch.from_numpy(feats),
                                                      torch.from_numpy(depth)) is None


@pytest.mark.parametrize("in_hw,out_hw", [((224, 224), (28, 28)), ((37, 41), (11, 13)),
                                          ((9, 9), 4)])
def test_adaptive_max_pool2d_matches_jax(in_hw, out_hw):
    x = RNG.standard_normal((2, 3, *in_hw)).astype(np.float32)
    ref = np.asarray(jresize.adaptive_max_pool2d(jnp.asarray(x), out_hw))
    np.testing.assert_array_equal(tresize.adaptive_max_pool2d(torch.from_numpy(x), out_hw).numpy(),
                                  ref)


@pytest.mark.parametrize("extra", [0, 2])
def test_hungarian_assignments_match_jax(extra):
    stats = RNG.integers(0, 100, (5 + extra, 5))
    ref = jmetrics.hungarian_assignments(stats, 5, extra)
    out = tmetrics.hungarian_assignments(stats, 5, extra)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extra,hungarian", [(0, True), (2, True), (0, False)])
def test_seg_metrics_update_and_cherry_match_jax(extra, hungarian):
    preds = RNG.integers(0, 5 + extra, (3, 2, 16, 16))
    target = RNG.integers(-1, 5, (3, 2, 16, 16))
    ref = jmetrics.SegMetrics("p/", 5, extra, hungarian)
    out = tmetrics.SegMetrics("p/", 5, extra, hungarian)
    for p, t in zip(preds, target):
        ref.update(p, t)
        out.update(torch.from_numpy(p), t)  # a tensor and an array
        ref.update_cherry(p, t)
        out.update_cherry(p, torch.from_numpy(t))
    np.testing.assert_array_equal(out.stats, ref.stats)
    assert out.compute() == ref.compute()
    np.testing.assert_array_equal(out.cherry_stats, ref.cherry_stats)
    assert out.compute_cherry() == ref.compute_cherry()
    emptied = out.compute_cherry()
    assert np.isnan(emptied["p/Accuracy"]) and not out.cherry_stats.any()
    m = tmetrics.SegMetrics("", 3, 0, True)  # the JAX test's case
    m.update_cherry(np.array([0, 1, 2, 1]), np.array([0, 1, 2, 0]))
    assert m.compute_cherry()["Accuracy"] == pytest.approx(75.0)
