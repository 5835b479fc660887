"""The contrastive correlation losses of the PyTorch port vs the JAX
package, on the CPU.

The same seeded numpy inputs, the same coordinates (``coords_override``)
and the same negatives' permutations (``neg_perms``) go through both, so no
random stream has to match. Tolerance: 1e-5 relative on every scalar loss
and 1e-5 absolute on the correlation tensors (float32 sums in another
order). The gradient of the loss with respect to the code is held too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.models import probes as jprobes
from depthg_tpu.train import losses as jloss
from depthg_tpu_torch.models import probes as tprobes
from depthg_tpu_torch.train import losses as tloss

torch.set_num_threads(1)

B, CF, CC, HW, S, NEG = 4, 12, 6, 5, 3, 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed=0, res=20):
    rng = np.random.default_rng(seed)
    vals = {
        "feats": rng.standard_normal((B, CF, HW, HW)), "feats_pos": rng.standard_normal((B, CF, HW, HW)),
        "code": rng.standard_normal((B, CC, HW, HW)), "code_pos": rng.standard_normal((B, CC, HW, HW)),
        "depth": rng.random((B, 1, res, res)) - 0.3, "depth_pos": rng.random((B, 1, res, res)),
        "coords1": rng.uniform(-1, 1, (B, S, S, 2)), "coords2": rng.uniform(-1, 1, (B, S, S, 2)),
    }
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    vals["perms"] = np.stack([rng.permutation(B) for _ in range(NEG)])
    return vals


def _cfgs(**kw):
    base = dict(feature_samples=S, neg_samples=NEG, depth_feat_shift=0.03)
    base.update(kw)
    return jloss.CorrLossConfig(**base), tloss.CorrLossConfig(**base)


def _rel(out, ref, rtol=1e-5):
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("pointwise", [True, False])
@pytest.mark.parametrize("stabalize", [True, False])
@pytest.mark.parametrize("zero_clamp", [True, False])
def test_corr_helper_matches_jax(pointwise, stabalize, zero_clamp):
    v = _inputs(1)
    jc, tc = _cfgs(pointwise=pointwise, stabalize=stabalize, zero_clamp=zero_clamp)
    args = [v["feats"][:, :, :S, :S], v["feats_pos"][:, :, :S, :S],
            v["code"][:, :, :S, :S] * 3, v["code_pos"][:, :, :S, :S]]
    ref_loss, ref_cd = jloss.corr_helper(jc, *map(jnp.asarray, args), 0.21)
    out_loss, out_cd = tloss.corr_helper(tc, *map(_t, args), 0.21)
    assert out_loss.shape == (B, S, S, S, S)
    np.testing.assert_allclose(out_loss.numpy(), np.asarray(ref_loss), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out_cd.numpy(), np.asarray(ref_cd), rtol=0, atol=1e-5)
    _rel(out_loss.mean(), ref_loss.mean())


def test_corr_helper_gives_no_gradient_to_the_feature_side():
    v = _inputs(2)
    _, tc = _cfgs()
    f = _t(v["feats"]).requires_grad_(True)
    c = _t(v["code"]).requires_grad_(True)
    loss, _ = tloss.corr_helper(tc, f, f, c, c, 0.1)
    loss.mean().backward()
    assert f.grad is None and c.grad is not None and bool(c.grad.abs().sum() > 0)


@pytest.mark.parametrize("stabalize", [True, False])
def test_depth_feature_correlation_matches_jax(stabalize):
    """The one-channel depth normalizes to its sign pattern (the depth here
    has both signs)."""
    v = _inputs(3)
    jc, tc = _cfgs(stabalize=stabalize)
    c = v["code"][:, :, :S, :S]
    ref_loss, ref_dd = jloss.depth_feature_correlation(
        jc, jnp.asarray(c), jnp.asarray(c), jnp.asarray(v["depth"]), jnp.asarray(v["depth"]), 0.03)
    out_loss, out_dd = tloss.depth_feature_correlation(
        tc, _t(c), _t(c), _t(v["depth"]), _t(v["depth"]), 0.03)
    np.testing.assert_allclose(out_loss.numpy(), np.asarray(ref_loss), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out_dd.numpy(), np.asarray(ref_dd), rtol=0, atol=1e-6)
    assert set(np.unique(np.round(out_dd.numpy(), 5))) <= {-1.0, 0.0, 1.0}


def _full_loss_jax(jc, v, perms_key=None, shift=None):
    return jloss.contrastive_correlation_loss(
        jax.random.PRNGKey(0) if perms_key is None else perms_key, jc,
        *(jnp.asarray(v[k]) for k in ("feats", "feats_pos", "code", "code_pos")),
        depth=jnp.asarray(v["depth"]), depth_pos=jnp.asarray(v["depth_pos"]),
        coords_override=(jnp.asarray(v["coords1"]), jnp.asarray(v["coords2"])),
        depth_feat_shift=shift)


@pytest.mark.parametrize("depth_feat", [True, False])
def test_full_loss_matches_jax_with_fixed_coords_and_perms(depth_feat):
    v = _inputs(4)
    jc, tc = _cfgs(depth_feat_correlation_loss=depth_feat)
    ref = _full_loss_jax(jc, v, shift=0.05)
    perms = np.asarray(ref["neg_perms"])  # what the JAX key drew
    code = _t(v["code"]).requires_grad_(True)
    out = tloss.contrastive_correlation_loss(
        tc, _t(v["feats"]), _t(v["feats_pos"]), code, _t(v["code_pos"]),
        depth=_t(v["depth"]), depth_pos=_t(v["depth_pos"]),
        coords_override=(_t(v["coords1"]), _t(v["coords2"])),
        neg_perms=_t(perms), depth_feat_shift=0.05)
    names = ["pos_intra_loss", "pos_inter_loss"] + (["depth_feat_loss"] if depth_feat else [])
    for name in names:
        _rel(out[name], ref[name])
    assert ("depth_feat_loss" in out) == depth_feat
    assert out["neg_inter_loss"].shape == (NEG, B, S, S, S, S)
    np.testing.assert_allclose(out["neg_inter_loss"].detach().numpy(),
                               np.asarray(ref["neg_inter_loss"]), rtol=0, atol=1e-5)
    _rel(out["neg_inter_loss"].mean(), ref["neg_inter_loss"].mean())
    for name in ("pos_intra_cd", "pos_inter_cd", "neg_inter_cd"):
        np.testing.assert_allclose(out[name].detach().numpy(), np.asarray(ref[name]),
                                   rtol=0, atol=1e-5)
    assert torch.equal(out["neg_perms"], _t(perms))

    # the gradient with respect to the code, through sample and both helpers
    def total_jax(c):
        r = jloss.contrastive_correlation_loss(
            jax.random.PRNGKey(0), jc, jnp.asarray(v["feats"]), jnp.asarray(v["feats_pos"]),
            c, jnp.asarray(v["code_pos"]), depth=jnp.asarray(v["depth"]),
            depth_pos=jnp.asarray(v["depth_pos"]),
            coords_override=(jnp.asarray(v["coords1"]), jnp.asarray(v["coords2"])))
        return r["pos_intra_loss"] + r["pos_inter_loss"] + r["neg_inter_loss"].mean()

    (out["pos_intra_loss"] + out["pos_inter_loss"] + out["neg_inter_loss"].mean()).backward()
    np.testing.assert_allclose(code.grad.numpy(), np.asarray(jax.grad(total_jax)(jnp.asarray(v["code"]))),
                               rtol=1e-4, atol=1e-7)


def test_negatives_take_their_means_per_permutation():
    """One mean over the stacked negatives would be a different loss: each
    permutation's block equals a call of its own."""
    v = _inputs(5)
    _, tc = _cfgs(depth_feat_correlation_loss=False)
    args = [_t(v[k]) for k in ("feats", "feats_pos", "code", "code_pos")]
    coords = (_t(v["coords1"]), _t(v["coords2"]))
    both = tloss.contrastive_correlation_loss(tc, *args, coords_override=coords,
                                              neg_perms=_t(v["perms"]))
    for i in range(NEG):
        one = tloss.contrastive_correlation_loss(tc, *args, coords_override=coords,
                                                 neg_perms=_t(v["perms"][i:i + 1]))
        assert torch.equal(one["neg_inter_loss"][0], both["neg_inter_loss"][i])


def test_depth_only_intra_variant_matches_jax():
    v = _inputs(6)
    jc, tc = _cfgs()
    rng = np.random.default_rng(60)
    aug = rng.standard_normal((B, CF, HW, HW)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jloss.depth_contrastive_correlation_loss(
        key, jc, *(jnp.asarray(v[k]) for k in ("feats", "feats_pos", "code", "code_pos")),
        depth_aug_feats=jnp.asarray(aug), depth_aug_feats_pos=jnp.asarray(aug),
        coords_override=(jnp.asarray(v["coords1"]), jnp.asarray(v["coords2"])))
    # the permutations as the JAX function derives them from its key
    _, kn = jax.random.split(key)
    perms = np.stack([np.asarray(jloss.super_perm(k, B)) for k in jax.random.split(kn, NEG)])
    out = tloss.depth_contrastive_correlation_loss(
        tc, *(_t(v[k]) for k in ("feats", "feats_pos", "code", "code_pos")),
        depth_aug_feats=_t(aug), depth_aug_feats_pos=_t(aug),
        coords_override=(_t(v["coords1"]), _t(v["coords2"])), neg_perms=_t(perms))
    for name in ("pos_intra_loss", "pos_inter_loss"):
        _rel(out[name], ref[name])
    _rel(out["neg_inter_loss"].mean(), ref["neg_inter_loss"].mean())
    assert "depth_feat_loss" not in out


def test_contrastive_crf_loss_matches_jax_with_fixed_coordinates():
    rng = np.random.default_rng(7)
    guidance = rng.standard_normal((2, 3, 14, 14)).astype(np.float32)
    clusters = rng.standard_normal((2, 5, 14, 14)).astype(np.float32)
    n = 40
    key = jax.random.PRNGKey(1)
    ref = jloss.contrastive_crf_loss(key, jnp.asarray(guidance), jnp.asarray(clusters), n,
                                     0.5, 0.15, 0.05, 10.0, 3.0, 0.02)
    kh, kw = jax.random.split(key)  # the coordinates as the JAX function draws them
    rows = np.asarray(jax.random.randint(kh, (n,), 0, 14))
    cols = np.asarray(jax.random.randint(kw, (n,), 0, 14))
    out = tloss.contrastive_crf_loss(_t(guidance), _t(clusters), n, 0.5, 0.15, 0.05,
                                     10.0, 3.0, 0.02,
                                     coords=(_t(rows).long(), _t(cols).long()))
    assert out.shape == (2, n, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    _rel(out.mean(), ref.mean())
    drawn = tloss.contrastive_crf_loss(_t(guidance), _t(clusters), n, 0.5, 0.15, 0.05,
                                       10.0, 3.0, 0.02, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (2, n, n) and bool(torch.isfinite(drawn).all())


@pytest.mark.parametrize("mode", ["fps", "fps_depth_feat", "simple", "none", "salience"])
def test_select_coords_modes(mode):
    """Shapes, ranges and seeding of every sampling mode; FPS equals the JAX
    package's coordinates (it draws nothing)."""
    v = _inputs(8)
    jc, tc = _cfgs(depth_sampling="none" if mode == "salience" else mode,
                   use_salience=mode == "salience")
    sal = (np.random.default_rng(9).random((B, 20, 20)) > 0.7).astype(np.float32)
    sal[0] = 0.0  # an empty map: uniform over all pixels
    args = (_t(v["feats"]), _t(v["feats_pos"]), _t(v["depth"]), _t(v["depth_pos"]),
            _t(sal), _t(sal))
    c1, c2 = tloss.select_coords(tc, *args, generator=torch.Generator().manual_seed(0))
    d1, d2 = tloss.select_coords(tc, *args, generator=torch.Generator().manual_seed(0))
    assert c1.shape == c2.shape == (B, S, S, 2)
    assert torch.equal(c1, d1) and torch.equal(c2, d2)
    assert float(c1.min()) >= -1.0 and float(c1.max()) <= 1.0
    if mode.startswith("fps"):
        r1, r2 = jloss.select_coords(jax.random.PRNGKey(0), jc, jnp.asarray(v["feats"]),
                                     jnp.asarray(v["feats_pos"]), jnp.asarray(v["depth"]),
                                     jnp.asarray(v["depth_pos"]))
        np.testing.assert_array_equal(c1.numpy(), np.asarray(r1))
        np.testing.assert_array_equal(c2.numpy(), np.asarray(r2))
    else:
        assert not torch.equal(c1, c2)


def test_salience_coords_fall_on_salient_pixels():
    sal = torch.zeros(2, 8, 8)
    sal[0, 2, 5] = 1.0
    sal[1, 6, 1] = 3.0
    c = tloss._salience_coords(sal, (2, 3, 3, 2), torch.Generator().manual_seed(0))
    # (x, y) after the flip, both divided by H
    assert torch.allclose(c[0], torch.tensor([5 / 8 * 2 - 1, 2 / 8 * 2 - 1]).expand(3, 3, 2))
    assert torch.allclose(c[1], torch.tensor([1 / 8 * 2 - 1, 6 / 8 * 2 - 1]).expand(3, 3, 2))


def test_corr_loss_config_from_cfg_matches_jax():
    from depthg_tpu.config import load_config as jload
    from depthg_tpu_torch.config import load_config as tload

    over = ["feature_samples=7", "stabalize=True", "depth_sampling=simple", "depth_feat_shift=0.03"]
    ref = jloss.from_cfg(jload("local_config.yml", over))
    out = tloss.from_cfg(tload("local_config.yml", over))
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    assert out.min_val == ref.min_val == 0.0


@pytest.mark.parametrize("alpha", [None, 2.0])
def test_cluster_lookup_apply_training_side_matches_jax(alpha):
    """``alpha=None``: one-hot argmax probs that carry no gradient; the loss
    -(probs * ip).sum(1).mean() and its gradient to the centroids."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 6, 4, 4)).astype(np.float32)
    clusters = rng.standard_normal((5, 6)).astype(np.float32)
    ref_loss, ref_probs = jprobes.cluster_lookup_apply({"clusters": jnp.asarray(clusters)},
                                                       jnp.asarray(x), alpha)
    cl = _t(clusters).requires_grad_(True)
    out_loss, out_probs = tprobes.cluster_lookup_apply(cl, _t(x), alpha, log_probs=False)
    _rel(out_loss, ref_loss)
    np.testing.assert_allclose(out_probs.detach().numpy(), np.asarray(ref_probs), rtol=0, atol=1e-6)
    assert out_probs.requires_grad == (alpha is not None)
    out_loss.backward()
    ref_grad = jax.grad(lambda c: jprobes.cluster_lookup_apply(
        {"clusters": c}, jnp.asarray(x), alpha)[0])(jnp.asarray(clusters))
    np.testing.assert_allclose(cl.grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-7)
    with pytest.raises(ValueError, match="alpha"):
        tprobes.cluster_lookup_apply(cl, _t(x), None)


def test_decoders_and_resize_and_classify_match_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, 4, 4)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    fp = jprobes.full_decoder_init(key, 6, 9)
    dec = tprobes.FullDecoder(6, 9)
    with torch.no_grad():
        for conv, name in ((dec.linear, "linear"), (dec.nonlinear[0], "nl1"),
                           (dec.nonlinear[2], "nl2"), (dec.nonlinear[4], "nl3")):
            conv.weight.copy_(_t(fp[name]["w"]).t()[:, :, None, None])
            conv.bias.copy_(_t(fp[name]["b"]))
    np.testing.assert_allclose(dec(_t(x)).detach().numpy(),
                               np.asarray(jprobes.full_decoder_apply(fp, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    lp = jprobes.linear_probe_init(key, 6, 3)
    conv = torch.nn.Conv2d(6, 3, 1)
    with torch.no_grad():
        conv.weight.copy_(_t(lp["w"]).t()[:, :, None, None])
        conv.bias.copy_(_t(lp["b"]))
    np.testing.assert_allclose(tprobes.resize_and_classify(conv, _t(x), 9).detach().numpy(),
                               np.asarray(jprobes.resize_and_classify(lp, jnp.asarray(x), 9)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tprobes.linear_probe_apply(conv, _t(x)).detach().numpy(),
                               np.asarray(jprobes.linear_probe_apply(lp, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    # seeded inits with torch's default bound
    a = tprobes.FullDecoder(6, 9).init_weights(torch.Generator().manual_seed(1))
    b = tprobes.FullDecoder(6, 9).init_weights(torch.Generator().manual_seed(1))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert float(a.linear.weight.abs().max()) <= 6 ** -0.5
