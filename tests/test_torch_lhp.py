"""The LHP head of the PyTorch port (``depthg_tpu_torch/models/lhp.py``) vs
the JAX package's ``depthg_tpu/models/lhp.py``, on the CPU.

Inputs are seeded numpy arrays; the head's weights are carried from JAX's
``lhp_init`` through ``lhp_state_dict_from_jax``. Tolerances: ``quantile`` and
``neighborhood_mask`` exactly; the attention affinity 1e-6 absolute and the
depth affinity 2e-3 absolute, each with the same zero pattern (for the
depth affinity: but where the normalized distance lies within 2e-3 of its
row's threshold); the
projected code 1e-5 relative; the "original" variants' +-inf and NaN at the
same places. The depth affinity's distances are the |a|^2 + |b|^2 - 2ab
expansion in float32 on both sides, as the reference's ``torch.cdist``
computes them: with |a|^2 near 25 it rounds a near neighbour's distance by
~1e-3 relative, differently in the two packages (measured 8.4e-4 at
224 px; one entry of 1.8 million flips, next to its threshold).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.models import lhp as jlhp
from depthg_tpu_torch.models import lhp as tlhp
from depthg_tpu_torch.models import vit as tvit
from depthg_tpu_torch.utils.ckpt import lhp_state_dict_from_jax

torch.set_num_threads(1)
RNG = np.random.default_rng(9)


def _heads(cfg_kw, seed=0):
    jcfg, tcfg = jlhp.LHPConfig(**cfg_kw), tlhp.LHPConfig(**cfg_kw)
    params = jlhp.lhp_init(jax.random.PRNGKey(seed), jcfg)
    head = tlhp.LHP(tcfg)
    head.load_state_dict(lhp_state_dict_from_jax(params), strict=True)
    return jcfg, params, head.requires_grad_(False)


@pytest.mark.parametrize("q", [0.01, 0.1, 0.5, 0.9, 0.99])
@pytest.mark.parametrize("ties", [False, True])
def test_quantile_matches_jnp_quantile_bitwise(q, ties):
    """``torch.quantile`` interpolates with lerp and differs from
    ``jnp.quantile`` by an ulp where two order statistics tie; the port's
    copy of the JAX formula does not."""
    x = RNG.random((3, 64, 784)).astype(np.float32)
    if ties:
        x = (np.round(x * 20) / 20).astype(np.float32)
    x[0, 0, 5] = np.nan  # a row holding a NaN gives NaN
    ref = np.asarray(jnp.quantile(jnp.asarray(x), q, axis=-1, keepdims=True))
    out = tlhp.quantile(torch.from_numpy(x), q).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("sz", [1, 2, 4, 7, 28])
def test_neighborhood_mask_matches_jax(sz):
    np.testing.assert_array_equal(tlhp.neighborhood_mask(sz), jlhp.neighborhood_mask(sz))
    m = tlhp.neighborhood_mask(4)
    assert m[0].sum() == 4 and m[1].sum() == 6 and m[5].sum() == 9 and (m == m.T).all()


@pytest.mark.parametrize("original", [False, True])
@pytest.mark.parametrize("res,grid", [(56, 7), (224, 28)])
def test_depth_affinity_matches_jax(original, res, grid):
    depth = np.random.default_rng(res).random((3, 1, res, res)).astype(np.float32)
    ref = np.asarray(jlhp._depth_affinity(jnp.asarray(depth), (grid, grid), original))
    out = tlhp._depth_affinity(torch.from_numpy(depth), (grid, grid), original).numpy()
    normed, thresh = tlhp._depth_normed(torch.from_numpy(depth), (grid, grid), original)
    near = (normed - thresh).abs().numpy() <= 2e-3
    flips = (out == 0) != (ref == 0)
    assert not (flips & ~near).any() and flips.sum() <= 1e-5 * flips.size, flips.sum()
    np.testing.assert_allclose(np.where(flips, 0, out), np.where(flips, 0, ref),
                               rtol=0, atol=2e-3)
    assert (ref == 0).mean() > 0.3  # the threshold keeps the near neighbours only


@pytest.mark.parametrize("original", [False, True])
def test_attn_affinity_matches_jax(original):
    attn = RNG.random((2, 3, 50, 50)).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    ref = np.asarray(jlhp._attn_affinity(jnp.asarray(attn), original))
    out = tlhp._attn_affinity(torch.from_numpy(attn), original).numpy()
    np.testing.assert_array_equal(out == 0, ref == 0)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("strategy", ["depth", "attn"])
@pytest.mark.parametrize("original", [False, True])
def test_lhp_apply_matches_jax(strategy, original):
    jcfg, params, head = _heads(dict(dim=8, res=56, patch_size=8,
                                     propagation_strategy=strategy, original=original))
    code = RNG.standard_normal((2, 8, 7, 7)).astype(np.float32)
    depth = RNG.random((2, 1, 56, 56)).astype(np.float32)
    attn = RNG.random((2, 2, 50, 50)).astype(np.float32)
    ref = np.asarray(jlhp.lhp_apply(params, jcfg, jnp.asarray(code), jnp.asarray(depth),
                                    None, jnp.asarray(attn)))
    out = tlhp.lhp_apply(head, torch.from_numpy(code), torch.from_numpy(depth),
                         torch.from_numpy(attn)).numpy()
    if original:  # divided by the reference's all-zero divide_num
        np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
        np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
        assert not np.isfinite(ref).all()
        keep = np.isfinite(ref)
        np.testing.assert_allclose(out[keep], ref[keep], rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_lhp_apply_dispatch():
    """No depth: the projection alone; the "depth" strategy propagates
    without attention maps (the kernel path returns none), the "attn"
    strategy without them is the projection alone."""
    jcfg, params, head = _heads(dict(dim=4, res=16, patch_size=8))
    code = RNG.standard_normal((2, 4, 2, 2)).astype(np.float32)
    depth = RNG.random((2, 1, 16, 16)).astype(np.float32)
    c, d = torch.from_numpy(code), torch.from_numpy(depth)
    proj = tlhp.lhp_apply(head, c)
    np.testing.assert_allclose(
        proj.numpy(), np.asarray(jlhp.lhp_apply(params, jcfg, jnp.asarray(code))),
        rtol=1e-5, atol=1e-6)
    assert not torch.allclose(tlhp.lhp_apply(head, c, d, None), proj)
    _, _, attn_head = _heads(dict(dim=4, res=16, patch_size=8, propagation_strategy="attn"))
    assert torch.equal(tlhp.lhp_apply(attn_head, c, d, None), attn_head.project(c))
    bad = tlhp.LHP(tlhp.LHPConfig(dim=4, propagation_strategy="nope"))
    with pytest.raises(ValueError, match="propagation strategy"):
        tlhp.lhp_apply(bad, c, d, None)


def test_lhp_head_is_drawn_from_the_generator():
    a = tlhp.LHP(tlhp.LHPConfig(dim=6)).init_weights(torch.Generator().manual_seed(3))
    b = tlhp.LHP(tlhp.LHPConfig(dim=6)).init_weights(torch.Generator().manual_seed(3))
    a.requires_grad_(False)  # as state_from_model freezes it: the gradient stops at the code
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q) and not p.requires_grad and q.requires_grad, name
        assert float(p.abs().max()) <= 6 ** -0.5
    assert sorted(a.state_dict()) == ["proj.fc1.bias", "proj.fc1.weight",
                                      "proj.fc2.bias", "proj.fc2.weight"]
    code = torch.randn(2, 6, 3, 3, requires_grad=True)
    tlhp.lhp_apply(a, code, torch.rand(2, 1, 24, 24)).sum().backward()
    assert code.grad is not None and a.proj.fc1.weight.grad is None


def test_need_attn_resolves_the_eager_path_and_refuses_the_kernel():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tvit.resolve_attn_impl("auto", None, cuda) == "fused"
    assert tvit.resolve_attn_impl("auto", None, cuda, need_attn=True) == "xla"
    assert tvit.resolve_attn_impl("xla", None, cuda, need_attn=True) == "xla"
    assert tvit.resolve_attn_impl("auto", None, cpu, need_attn=True) == "xla"
    for impl in ("fused", "flash"):
        assert tvit.resolve_attn_impl(impl, None, cuda) == impl
        with pytest.raises(ValueError, match="cannot return attention maps"):
            tvit.resolve_attn_impl(impl, None, cuda, need_attn=True)


def test_distances_refuse_tf32(monkeypatch):
    """On CUDA the distances must be float32 products; the CPU never uses
    TF32, so only a CUDA tensor is checked (a fake one here)."""
    pts = torch.rand(1, 5, 3)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    np.testing.assert_allclose(tlhp._pairwise_dists(pts).numpy(),
                               torch.cdist(pts, pts).numpy(), atol=1e-6)

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    with pytest.raises(RuntimeError, match="TF32"):
        tlhp._pairwise_dists(pts.as_subclass(FakeCuda))
