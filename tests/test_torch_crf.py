"""Dense CRF of the PyTorch port vs the JAX package: the default point,
then every other configuration ``crf_config_from_cfg`` reaches (the
``safe`` point, the legacy schedule, bf16/f32 caches, the broadcast splat,
the exact ds=1 CRF and ds=2 streaming), at 64 px.

At the default point, inputs are a fidelity-study scene (``scripts/crf_fidelity_study.make_scene``)
at 160 px: ds=8 with 4 phases gives 4 x 400 = 1600 phase points, the same
schedule (cp5 -> m4 -> f1) and int8 cache as the 320 px eval default.
With float32 state the port is held to Q within 1e-4 everywhere and
labels on >= 99.9% of pixels, against the JAX mean field run
eagerly on the same int8 cache (the port reads the cache the JAX operator
built). Both halves of that setup matter (measured on this scene):
* ``jax.jit`` of the same JAX function moves Q by up to ~1.4e-2 against its
  own eager run (XLA:CPU fuses and reorders the float32 mean field, and the
  10 softmax iterations amplify it), while on the same cache the port
  matches the eager run to ~4e-7;
* each framework's own float32 build of the log-kernel a.b - |a|^2/2 -
  |b|^2/2 (terms of ~2e4) puts ~1 in 10^4 int8 entries one step apart,
  which moves Q by up to ~1e-2 with labels unchanged.
So the end-to-end comparison with each side's own cache and a jitted JAX
holds Q to 1e-4 on 99.5% of its entries and 2e-2 everywhere, labels to
99.9%. With the default bf16 state the two frameworks also round the state
at different places, so only labels are compared.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu.ops import crf as jcrf
from depthg_tpu_torch.ops import crf as tcrf

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "crf_fidelity_study",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "scripts", "crf_fidelity_study.py"))
fidelity = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fidelity)


@pytest.fixture(scope="module")
def scene():
    image, gt, logits = fidelity.make_scene(160, 27, seed=0)
    logits2 = fidelity.make_scene(160, 27, seed=1)[2]  # a second probe
    return image, gt, logits, logits2


def _configs(dtype):
    return (dataclasses.replace(jcrf.crf_config_from_cfg({}), dtype=dtype),
            dataclasses.replace(tcrf.crf_config_from_cfg({}), dtype=dtype))


def _run_port(scene, ct):
    image, _, logits, logits2 = scene
    qt = tcrf.dense_crf_multi_batch(torch.from_numpy(image)[None],
                                    [torch.from_numpy(logits)[None],
                                     torch.from_numpy(logits2)[None]], ct)
    return [q[0].numpy() for q in qt]


def _run_both(scene, dtype):
    image, _, logits, logits2 = scene
    cj, ct = _configs(dtype)
    qj = jax.jit(lambda im, a, b: jcrf.dense_crf_multi(im, [a, b], cj))(
        jnp.asarray(image), jnp.asarray(logits), jnp.asarray(logits2))
    return [np.asarray(q) for q in qj], _run_port(scene, ct)


def test_default_point_f32_state_matches_jax(scene, monkeypatch):
    image, _, logits, logits2 = scene
    cj, ct = _configs("float32")
    kmat = np.array(jcrf._jbu_operator(jnp.asarray(image), cj, 8, jnp.float32,
                                         jcrf._jbu_phases(cj, 160, 160))[3])
    monkeypatch.setattr(tcrf, "cache_kernel_int8",
                        lambda feats: torch.from_numpy(kmat)[None])
    qj = jcrf.dense_crf_multi(jnp.asarray(image),
                              [jnp.asarray(logits), jnp.asarray(logits2)], cj)
    for a, b in zip(qj, _run_port(scene, ct)):
        a = np.asarray(a)
        assert b.shape == a.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
        assert (b.argmax(0) == a.argmax(0)).mean() >= 0.999


def test_default_point_f32_state_own_caches(scene):
    qj, qt = _run_both(scene, "float32")
    for a, b in zip(qj, qt):
        assert b.shape == a.shape
        diff = np.abs(b - a)
        assert (diff <= 1e-4).mean() >= 0.995
        assert diff.max() <= 2e-2
        assert (b.argmax(0) == a.argmax(0)).mean() >= 0.999


def test_default_point_bf16_state_label_agreement(scene):
    qj, qt = _run_both(scene, "bfloat16")
    for a, b in zip(qj, qt):
        assert np.isfinite(b).all()
        assert (b.argmax(0) == a.argmax(0)).mean() >= 0.995


@pytest.mark.parametrize("name", sorted(jcrf.EVAL_OPERATING_POINTS))
def test_operating_points_resolve_like_jax(name):
    assert tcrf.EVAL_OPERATING_POINTS[name] == jcrf.EVAL_OPERATING_POINTS[name]
    cfg = dict(o.split("=", 1) for o in tcrf.operating_point_overrides(name))
    cfg = {k: int(v) for k, v in cfg.items()}
    port, ref = tcrf.crf_config_from_cfg(cfg), jcrf.crf_config_from_cfg(cfg)
    for field in dataclasses.fields(port):
        assert getattr(port, field.name) == getattr(ref, field.name), field.name
    # the TPU-only fields the port leaves out stay at their JAX defaults
    dropped = {f.name for f in dataclasses.fields(ref)} - set(dataclasses.asdict(port))
    assert dropped == {"block", "use_pallas", "batch_strategy"}
    for name in dropped:
        assert getattr(ref, name) == getattr(jcrf.CRFConfig(), name)


# The override sets of the configurations beside the default point, at
# 64 px. Each is run with float32 state against the JAX ``dense_crf_multi``
# run eagerly (see the module docstring for jit) on the same scene and two
# probes. Kernel entries are exp of a float32 log-kernel whose JAX form
# a.b - |a|^2/2 - |b|^2/2 carries ~1e-3 of cancellation noise per entry
# (colors / 3 up to ~85); the cached points also round int8 entries one
# step apart where an entry sits on a boundary. Either moves Q on a few
# entries (measured: up to 1.5e-3, on at most 0.2% of the entries past
# 1e-4, labels identical), so Q is held to 1e-4 on 99.5% of its entries and
# 5e-3 everywhere, labels on 99.9% of pixels.
OTHER_POINTS = [{"crf_downsample": 4, "crf_splat_phases": 0},  # "safe"
                {"crf_mixed_resolution": False},
                {"crf_kernel_int8": False},
                {"crf_splat_impl": "broadcast"}]
# points that stream through the bilateral message (K4 on the card): the
# exact CRF and ds=2 with the cache turned off, as the JAX tests force it
STREAMING_POINTS = [{"crf_downsample": 1, "kernel_cache_mb": 0},
                    {"crf_downsample": 2, "kernel_cache_mb": 0}]


@pytest.fixture(scope="module")
def small_scene():
    image, gt, logits = fidelity.make_scene(64, 27, seed=2)
    return image, gt, logits, fidelity.make_scene(64, 27, seed=3)[2]


def _point_configs(overrides, dtype):
    cfg = {k: v for k, v in overrides.items() if k != "kernel_cache_mb"}
    extra = dict(dtype=dtype, kernel_cache_mb=overrides.get("kernel_cache_mb", 2700))
    return (dataclasses.replace(jcrf.crf_config_from_cfg(cfg), **extra),
            dataclasses.replace(tcrf.crf_config_from_cfg(cfg), **extra))


def _compare_point(scene, overrides, dtype):
    image, _, logits, logits2 = scene
    cj, ct = _point_configs(overrides, dtype)
    qj = jcrf.dense_crf_multi(jnp.asarray(image),
                              [jnp.asarray(logits), jnp.asarray(logits2)], cj)
    return [np.asarray(q) for q in qj], _run_port(scene, ct)


def _assert_f32_point_close(qj, qt):
    for a, b in zip(qj, qt):
        assert b.shape == a.shape
        diff = np.abs(b - a)
        assert (diff <= 1e-4).mean() >= 0.995
        assert diff.max() <= 5e-3
        assert (b.argmax(0) == a.argmax(0)).mean() >= 0.999


@pytest.mark.parametrize("overrides", OTHER_POINTS)
def test_unported_points_raise(small_scene, overrides):
    """The configurations away from the default point run and match JAX in
    float32 state. (The name dates from when the port refused them with
    NotImplementedError; it is kept so the case keeps its history.)"""
    _assert_f32_point_close(*_compare_point(small_scene, overrides, "float32"))


@pytest.mark.parametrize("overrides", STREAMING_POINTS)
def test_streaming_points_match_jax(small_scene, overrides, monkeypatch):
    """No cache: the degree goes through ``bilateral_degree`` and every
    message through ``bilateral_message`` (their plain version on the CPU):
    11 calls, the degree first and then 10 iterations."""
    calls = []
    real, real_degree = tcrf.bilateral_message, tcrf.bilateral_degree
    monkeypatch.setattr(tcrf, "bilateral_message",
                        lambda f, v: calls.append(v.shape) or real(f, v))
    monkeypatch.setattr(tcrf, "bilateral_degree",
                        lambda f: calls.append((*f.shape[:2], 1)) or real_degree(f))
    _assert_f32_point_close(*_compare_point(small_scene, overrides, "float32"))
    assert len(calls) == 11 and calls[0][-1] == 1
    assert all(shape[-1] == 54 for shape in calls[1:])


@pytest.mark.parametrize("overrides", OTHER_POINTS + STREAMING_POINTS)
def test_other_points_bf16_label_agreement(small_scene, overrides):
    """bf16 state: the frameworks round the state at different places, so
    only labels are compared."""
    qj, qt = _compare_point(small_scene, overrides, "bfloat16")
    for a, b in zip(qj, qt):
        assert np.isfinite(b).all()
        assert (b.argmax(0) == a.argmax(0)).mean() >= 0.995


def test_batch_runs_in_cache_sized_groups(small_scene, monkeypatch):
    """A batch whose caches exceed ``CACHE_BUDGET_BYTES`` runs in groups of
    images with the same result."""
    image, _, logits, _ = small_scene
    ct = tcrf.crf_config_from_cfg({"crf_downsample": 4, "crf_splat_phases": 0})
    images = torch.from_numpy(np.stack([image, image[:, ::-1].copy(), image]))
    lgs = torch.from_numpy(np.stack([logits, logits[:, ::-1].copy(), logits]))
    whole = tcrf.dense_crf_batch(images, lgs, ct)
    builds = []
    real = tcrf._cache_kernel
    monkeypatch.setattr(tcrf, "_cache_kernel",
                        lambda f, c, d: builds.append(f.shape[0]) or real(f, c, d))
    monkeypatch.setattr(tcrf, "CACHE_BUDGET_BYTES", 2 * 256 * 256 * 2)
    torch.testing.assert_close(tcrf.dense_crf_batch(images, lgs, ct), whole,
                               rtol=0, atol=0)
    assert builds == [2, 1]


def test_int8_cache_matches_float64_and_jax(scene):
    """The int8 cache entries round exp(-d^2/2) * 127; a float32 build may
    differ from the float64 one by at most one step where an entry sits on
    a rounding boundary."""
    image = scene[0][:, ::2, ::2]  # 80 px: 4 x 100 phase points
    ccfg = tcrf.crf_config_from_cfg({})
    phases = tcrf._jbu_phases(ccfg, 80, 80)
    _, _, kmat = tcrf._jbu_operator(torch.from_numpy(image)[None], ccfg, 8,
                                    torch.float32, phases)
    kt = kmat[0].numpy().astype(np.int32)
    feats = []
    for oy, ox in phases:
        ys, xs = np.meshgrid(np.arange(10) * 8 + oy, np.arange(10) * 8 + ox,
                             indexing="ij")
        f = np.concatenate([xs[None] / 67.0, ys[None] / 67.0,
                            image[:, oy::8, ox::8].astype(np.float64) / 3.0])
        feats.append(f.reshape(5, -1).T)
    f = np.concatenate(feats)
    d2 = ((f[:, None] - f[None]) ** 2).sum(-1)
    k64 = np.round(np.exp(-0.5 * d2) * 127.0).astype(np.int32)
    assert np.abs(kt - k64).max() <= 1
    kj = np.asarray(jcrf._cache_kernel(jnp.asarray(f, jnp.float32),
                                       jcrf.crf_config_from_cfg({}),
                                       jnp.float32)).astype(np.int32)
    assert np.abs(kt - kj).max() <= 1


def test_cached_matmul_matches_jax():
    rng = np.random.default_rng(3)
    k8 = rng.integers(0, 128, (64, 64)).astype(np.int8)
    z = rng.random((64, 10)).astype(np.float32)
    ref = np.asarray(jcrf._cached_matmul(jnp.asarray(k8), jnp.asarray(z),
                                         jnp.float32))
    out = tcrf.cached_matmul(torch.from_numpy(k8)[None],
                             torch.from_numpy(z)[None], torch.float32)[0]
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_lattice_agreement_matches_jax_on_a_small_scene():
    """The fidelity study's lattice column on one 96 px scene: the port's
    CRF and the JAX package's ``dense_crf_multi`` at the default point, each
    against the permutohedral lattice (the port's ``native_crf`` copy, on
    the softmax of the upsampled unary). The port's agreement is within 0.5
    points of the JAX package's (measured: 95.82% and 95.83%)."""
    from depthg_tpu_torch import crf_fidelity_study as study

    image, gt, logits = study.make_scene(96, 27, seed=3)
    lattice = study.lattice_labels([(image, gt, logits)], 96)
    cj, ct = _configs("bfloat16")
    qj = jax.jit(lambda im, a: jcrf.dense_crf_multi(im, [a], cj))(jnp.asarray(image),
                                                                  jnp.asarray(logits))
    qt = tcrf.dense_crf_multi_batch(torch.from_numpy(image)[None],
                                    [torch.from_numpy(logits)[None]], ct)
    jax_agree = study.agreement([np.asarray(qj[0]).argmax(0)], lattice)
    port_agree = study.agreement([qt[0][0].float().numpy().argmax(0)], lattice)
    assert 0.9 < port_agree <= 1.0
    assert abs(port_agree - jax_agree) <= 0.005, (port_agree, jax_agree)
