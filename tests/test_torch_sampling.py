"""The sampling, correlation and depth ops of the PyTorch port vs the JAX
package, on the CPU.

The same inputs, made from ``numpy.random.default_rng(seed)``, go through
the JAX function and its counterpart in the port. Tolerances: 1e-6 absolute
for the float outputs (float32 roundings of differently ordered sums),
equal indices for FPS. The depths are seeded generic values: near-ties
between two candidates of an FPS step could part the two frameworks where
their float32 roundings differ, and generic depths have none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.ops import correlation as jcorr
from depthg_tpu.ops import depth as jdepth
from depthg_tpu.ops import resize as jresize
from depthg_tpu.ops import sampling as jsamp
from depthg_tpu_torch.models.layers import dropout2d
from depthg_tpu_torch.ops import correlation as tcorr
from depthg_tpu_torch.ops import depth as tdepth
from depthg_tpu_torch.ops import resize as tresize
from depthg_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(1)


def _close(out, ref, atol=1e-6):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("shape,grid", [((2, 5, 7, 9), (4, 3)), ((1, 3, 4, 4), (6, 6))])
def test_grid_sample_and_sample_match_jax(shape, grid):
    """Coordinates reach past [-1, 1], so the border clamp is exercised."""
    rng = np.random.default_rng(0)
    t = rng.standard_normal(shape).astype(np.float32)
    g = rng.uniform(-1.2, 1.2, (shape[0], *grid, 2)).astype(np.float32)
    g[0, 0, 0] = (-1.0, 1.0)
    _close(tsamp.grid_sample(torch.from_numpy(t), torch.from_numpy(g)),
           jsamp.grid_sample(jnp.asarray(t), jnp.asarray(g)))
    if grid[0] == grid[1]:
        _close(tsamp.sample(torch.from_numpy(t), torch.from_numpy(g)),
               jsamp.sample(jnp.asarray(t), jnp.asarray(g)))


def test_sample_transposes_the_grid():
    rng = np.random.default_rng(1)
    t = torch.from_numpy(rng.standard_normal((2, 3, 5, 5)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 4, 2)).astype(np.float32))
    assert torch.equal(tsamp.sample(t, c), tsamp.grid_sample(t, c.permute(0, 2, 1, 3)))


@pytest.mark.parametrize("c", [1, 16, 70])
def test_tensor_correlation_matches_jax(c):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, c, 4, 5)).astype(np.float32)
    b = rng.standard_normal((3, c, 2, 6)).astype(np.float32)
    out = tcorr.tensor_correlation(torch.from_numpy(a), torch.from_numpy(b))
    assert out.shape == (3, 4, 5, 2, 6)
    _close(out, jcorr.tensor_correlation(jnp.asarray(a), jnp.asarray(b)), atol=1e-5)
    _close(out, np.einsum("nchw,ncij->nhwij", a.astype(np.float64), b.astype(np.float64)),
           atol=1e-5)


def test_norm_average_norm_one_hot_match_jax():
    rng = np.random.default_rng(3)
    t = rng.standard_normal((2, 6, 3, 3)).astype(np.float32)
    t[0, :, 0, 0] = 0.0  # a zero vector: divided by eps, stays 0
    _close(tcorr.norm(torch.from_numpy(t)), jcorr.norm(jnp.asarray(t)))
    _close(tcorr.average_norm(torch.from_numpy(t)), jcorr.average_norm(jnp.asarray(t)))
    labels = rng.integers(-1, 5, (2, 4, 4))
    _close(tcorr.one_hot_feats(torch.from_numpy(labels), 5),
           jcorr.one_hot_feats(jnp.asarray(labels), 5), atol=0)


def test_shuffle_is_a_seeded_permutation_of_rows():
    x = torch.arange(12.0).reshape(6, 2)
    a = tcorr.shuffle(x, torch.Generator().manual_seed(5))
    b = tcorr.shuffle(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert torch.equal(a.sort(0).values, x)


@pytest.mark.parametrize("size", [1, 2, 5, 32])
def test_super_perm_properties(size):
    """A permutation of range(size) except where the fixed-point bump made a
    duplicate (as in the reference); no fixed point survives for size > 1
    unless the bump created it; seeded."""
    for seed in range(20):
        perm = tsamp.super_perm(size, torch.Generator().manual_seed(seed))
        again = tsamp.super_perm(size, torch.Generator().manual_seed(seed))
        assert torch.equal(perm, again)
        assert perm.dtype == torch.long and perm.shape == (size,)
        assert int(perm.min()) >= 0 and int(perm.max()) < size
        base = torch.randperm(size, generator=torch.Generator().manual_seed(seed))
        fixed = base == torch.arange(size)
        assert torch.equal(perm[~fixed], base[~fixed])
        assert torch.equal(perm[fixed], (base[fixed] + 1) % size)


def test_super_perm_matches_the_jax_rule():
    """The same bump rule as the JAX package on the same base permutation."""
    key = jax.random.PRNGKey(0)
    ref = np.asarray(jsamp.super_perm(key, 9))
    base = np.asarray(jax.random.permutation(key, 9))
    bumped = np.where(base == np.arange(9), base + 1, base) % 9
    np.testing.assert_array_equal(ref, bumped)


def test_random_coords_range_and_seed():
    gen = torch.Generator().manual_seed(0)
    c = tsamp.random_coords((4, 3, 3, 2), gen)
    assert c.shape == (4, 3, 3, 2) and c.dtype == torch.float32
    assert float(c.min()) >= -1.0 and float(c.max()) < 1.0
    assert torch.equal(c, tsamp.random_coords((4, 3, 3, 2), torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("shape", [(6, 8), (1, 5, 5)])
def test_depth2points_matches_jax(shape):
    """Including the degrees-as-radians quirk: factor = 2 tan(fov / 2)."""
    rng = np.random.default_rng(4)
    d = rng.random(shape).astype(np.float32) + 0.1
    for fov in (30.0, 90.0):
        out = tdepth.depth2points(torch.from_numpy(d), fov=fov)
        _close(out, jdepth.depth2points(jnp.asarray(d), fov=fov), atol=2e-6)
    assert out.shape == (3, *shape[-2:])
    np.testing.assert_allclose(float(out[2].flatten()[0]), -5.0 * d.flatten()[0], rtol=1e-6)


@pytest.mark.parametrize("p,d,n", [(64, 3, 9), (100, 3, 100), (30, 5, 7)])
def test_fps_indices_equal_jax(p, d, n):
    pts = np.random.default_rng(5).standard_normal((p, d)).astype(np.float32)
    out = tdepth.fps_indices(torch.from_numpy(pts), n)
    ref = np.asarray(jdepth.fps_indices(jnp.asarray(pts), n))
    assert out.dtype == torch.long and int(out[0]) == 0
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(set(out.tolist())) == n  # never the same point twice


def test_fps_indices_tie_breaks():
    """A constant cloud (every distance 0) walks the indices in order, and
    duplicated points go to the lowest index first, as in the JAX package."""
    const = np.ones((12, 3), np.float32)
    np.testing.assert_array_equal(
        tdepth.fps_indices(torch.from_numpy(const), 5).numpy(), np.arange(5))
    np.testing.assert_array_equal(
        np.asarray(jdepth.fps_indices(jnp.asarray(const), 5)), np.arange(5))
    pts = np.random.default_rng(6).standard_normal((8, 3)).astype(np.float32)
    dup = np.concatenate([pts, pts])
    out = tdepth.fps_indices(torch.from_numpy(dup), 10).numpy()
    np.testing.assert_array_equal(out, np.asarray(jdepth.fps_indices(jnp.asarray(dup), 10)))


@pytest.mark.parametrize("b,hw,res,s", [(4, 4, 32, 3), (2, 7, 56, 4), (2, 6, 6, 6)])
def test_farthest_point_sampling_depth_matches_jax(b, hw, res, s):
    rng = np.random.default_rng(7)
    t = np.zeros((b, 2, hw, hw), np.float32)
    depth = rng.random((b, 1, res, res)).astype(np.float32)
    out = tdepth.farthest_point_sampling_depth(torch.from_numpy(t), torch.from_numpy(depth), s)
    ref = jdepth.farthest_point_sampling_depth(jnp.asarray(t), jnp.asarray(depth), s)
    assert out.shape == (b, s, s, 2)
    _close(out, ref, atol=0)
    flat = out.reshape(b, -1, 2)
    idx = flat[..., 0] * hw * hw + flat[..., 1] * hw
    assert bool((idx[:, 1:] > idx[:, :-1]).all())  # re-sorted row-major


def test_fps_depth_feats_indices_equal_jax():
    rng = np.random.default_rng(8)
    pts = rng.standard_normal((40, 3)).astype(np.float32)
    feats = rng.standard_normal((40, 6)).astype(np.float32)
    out = tdepth.fps_depth_feats_indices(torch.from_numpy(pts), torch.from_numpy(feats), 9)
    ref = jdepth.fps_depth_feats_indices(jnp.asarray(pts), jnp.asarray(feats), 9)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_knn_for_coords_matches_jax():
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((2, 4, 6, 6)).astype(np.float32)
    cells = np.stack([rng.permutation(36)[:4] for _ in range(2)])
    coords = np.stack([(cells // 6) / 6.0, (cells % 6) / 6.0], -1).astype(np.float32)
    coords = coords.reshape(2, 2, 2, 2)
    out = tdepth.knn_for_coords(torch.from_numpy(feats), torch.from_numpy(coords), 2)
    ref = jdepth.knn_for_coords(jnp.asarray(feats), jnp.asarray(coords), 2)
    assert out.shape == (2, 4 + 4 * 3, 2)  # anchors, then k + 1 picks each
    _close(out, ref)
    with pytest.raises(ValueError):
        tdepth.knn_for_coords(torch.from_numpy(feats), torch.from_numpy(coords), 0)


def test_uniform_pixel_coords_are_pixel_centres():
    gen = torch.Generator().manual_seed(0)
    c = tdepth.uniform_pixel_coords(3, 4, (5, 7), gen)
    assert c.shape == (3, 4, 4, 2) and c.dtype == torch.float32
    rows, cols = c[..., 0] * 5 - 0.5, c[..., 1] * 7 - 0.5
    assert torch.allclose(rows, rows.round(), atol=1e-5)
    assert torch.allclose(cols, cols.round(), atol=1e-5)
    assert 0 <= float(rows.min()) and float(rows.max()) <= 4
    assert 0 <= float(cols.min()) and float(cols.max()) <= 6


@pytest.mark.parametrize("in_hw,out_hw", [((32, 32), (4, 4)), ((10, 7), (3, 5)),
                                          ((224, 224), (28, 28)), ((5, 5), (5, 5))])
def test_adaptive_avg_pool2d_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(10).standard_normal((2, 1, *in_hw)).astype(np.float32)
    out = tresize.adaptive_avg_pool2d(torch.from_numpy(x), out_hw)
    _close(out, jresize.adaptive_avg_pool2d(jnp.asarray(x), out_hw))
    assert out.shape == (2, 1, *out_hw)


def test_dropout2d_zeroes_whole_channels_and_rescales():
    x = torch.ones(8, 64, 3, 3) * 2.0
    gen = torch.Generator().manual_seed(0)
    y = dropout2d(x, 0.25, True, gen)
    per_channel = y.flatten(2)
    assert bool(((per_channel == 0).all(-1) | (per_channel == 2.0 / 0.75).all(-1)).all())
    dropped = float((per_channel[..., 0] == 0).float().mean())
    assert 0.15 < dropped < 0.35
    assert torch.equal(y, dropout2d(x, 0.25, True, torch.Generator().manual_seed(0)))
    assert dropout2d(x, 0.25, False) is x and dropout2d(x, 0.0, True) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout2d(x, 0.25, True)
