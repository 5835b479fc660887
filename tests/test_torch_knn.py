"""The port's dataset-wide KNN (``depthg_tpu_torch/parallel/knn.py``) on the
CPU against the JAX package's, on the same seeded features: indices equal
where similarities are more than 1e-5 apart (float32 products on both
sides: ``precision="highest"``), int32 [N, k]; zero-padded key rows never
returned; the key-blocked branch and its merge equal to the one-pass branch
(``_KEY_BLOCK`` made small so both run); ``pooled_features`` within 1e-5 of
the JAX function from carried weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depthg_tpu.models import featurizer as jfeat
from depthg_tpu.models import vit as jvit
from depthg_tpu.parallel import knn as jknn
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.models import vit as tvit
from depthg_tpu_torch.parallel import knn as tknn
from depthg_tpu_torch.utils.ckpt import vit_state_dict

torch.set_num_threads(1)


def _unit(n, c, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, c)).astype(np.float32)
    return feats / np.linalg.norm(feats, axis=1, keepdims=True)


def _assert_same_neighbors(out, ref, feats, gap=1e-5):
    """Equal indices, except where the two picks' similarities to the query
    lie within ``gap`` (a near-tie either side may order either way)."""
    assert out.shape == ref.shape
    rows, cols = np.nonzero(out != ref)
    f64 = feats.astype(np.float64)
    for r, c in zip(rows, cols):
        a, b = f64[r] @ f64[out[r, c]], f64[r] @ f64[ref[r, c]]
        assert abs(a - b) <= gap, (r, c, a, b)
    return len(rows)


@pytest.mark.parametrize("n,c,k,chunk", [(300, 16, 10, 128), (257, 32, 30, 64),
                                         (64, 8, 5, 1024)])
def test_topk_neighbors_matches_jax_package(n, c, k, chunk):
    feats = _unit(n, c, seed=n)
    ref = np.asarray(jknn.topk_neighbors(jnp.asarray(feats), k=k, chunk=chunk,
                                         precision="highest"))
    out = tknn.topk_neighbors(feats, k=k, chunk=chunk, precision="highest",
                              device="cpu")
    assert out.dtype == np.int32 == ref.dtype and out.shape == (n, k)
    _assert_same_neighbors(out, ref, feats)
    assert (out[:, 0] == np.arange(n)).all()
    # a torch tensor is taken as it is, and the default precision on the CPU
    # is the float32 product too
    again = tknn.topk_neighbors(torch.from_numpy(feats), k=k, chunk=chunk, device="cpu")
    np.testing.assert_array_equal(again, out)


def test_topk_pad_rows_excluded_and_matches_unpadded():
    """Zero rows appended as padding (what a sharded caller would add) are
    never returned, though their similarity 0 outranks the negative ones."""
    n = 300
    feats = _unit(n, 16, seed=0)
    feats[n // 2:] = -feats[: n - n // 2]  # real similarities go negative
    ref = tknn.topk_neighbors(feats, k=10, chunk=128, precision="highest", device="cpu")
    assert ref.max() < n and (ref[:, 0] == np.arange(n)).all()
    single = np.asarray(jknn.topk_neighbors(jnp.asarray(feats), k=10, chunk=128,
                                            precision="highest"))
    _assert_same_neighbors(ref, single, feats)

    padded = torch.from_numpy(np.concatenate([feats, np.zeros((84, 16), np.float32)]))
    out = tknn._topk_inner(padded, padded, 10, 128, valid_n=n)[:n].numpy()
    assert out.max() < n, "padded key rows leaked into top-k"
    np.testing.assert_array_equal(out, ref)
    unmasked = tknn._topk_inner(padded, padded, 200, 128)[:n].numpy()
    assert unmasked.max() >= n  # without the mask the zero rows do win


@pytest.mark.parametrize("n", [300, 321])
def test_topk_key_blocking_matches_single_pass(monkeypatch, n):
    """The two-level (per-key-block) top-k is exactly the global top-k; tiny
    blocks so the blocked path runs (n=321: a last block of one key, fewer
    than k), with and without masked padding, and equal to the JAX
    package's blocked branch."""
    feats = _unit(n, 16, seed=3)
    ref = tknn.topk_neighbors(feats, k=7, chunk=64, precision="highest", device="cpu")
    monkeypatch.setattr(tknn, "_KEY_BLOCK", 64)
    assert n > 2 * tknn._KEY_BLOCK
    blocked = tknn.topk_neighbors(feats, k=7, chunk=64, precision="highest", device="cpu")
    np.testing.assert_array_equal(blocked, ref)

    padded = torch.from_numpy(np.concatenate([feats, np.zeros((50, 16), np.float32)]))
    out = tknn._topk_inner(padded, padded, 7, 64, valid_n=n)[:n].numpy()
    np.testing.assert_array_equal(out, ref)

    monkeypatch.setattr(jknn, "_KEY_BLOCK", 64)
    jknn._topk_chunked.clear_cache()
    jref = np.asarray(jknn.topk_neighbors(jnp.asarray(feats), k=7, chunk=64,
                                          precision="highest"))
    jknn._topk_chunked.clear_cache()
    _assert_same_neighbors(blocked, jref, feats)


def test_topk_neighbors_refuses_what_is_not_ported():
    feats = _unit(8, 4, seed=1)
    with pytest.raises(ValueError, match="needs a process group"):
        tknn.topk_neighbors(feats, k=2, group=object(), device="cpu")
    with pytest.raises(ValueError, match="precision"):
        tknn.topk_neighbors(feats, k=2, precision="bfloat16", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            tknn.topk_neighbors(feats, k=2)


@pytest.mark.parametrize("feat_type", ["feat", "KK"])
def test_pooled_features_match_jax_package(feat_type):
    tiny = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2)
    jfcfg = jfeat.FeaturizerConfig(arch="vit_small", patch_size=8, dim=16,
                                   feat_type=feat_type, vit_config=jvit.ViTConfig(**tiny))
    params = jfeat.featurizer_init(jax.random.PRNGKey(0), jfcfg)
    tfcfg = tfeat.FeaturizerConfig(dim=16, feat_type=feat_type,
                                   vit_config=tvit.ViTConfig(**tiny))
    net = tfeat.DinoFeaturizer(tfcfg)
    host = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params["vit"])
    net.model.load_state_dict(vit_state_dict(host), strict=True)

    img = np.random.default_rng(5).standard_normal((3, 3, 48, 40)).astype(np.float32)
    ref = np.asarray(jknn.pooled_features({"vit": params["vit"]}, jnp.asarray(img), jfcfg,
                                          "highest"))
    out = tknn.pooled_features(net.eval(), torch.from_numpy(img), "highest").numpy()
    assert out.shape == ref.shape == (3, 64) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-6)
