"""The eval step of the PyTorch port vs the JAX package, end to end.

Tiny segmenter (2-block 128-wide ViT, code dim 16, 5 classes + 2 extra
clusters) at 64 px, batch 2, on fidelity-study scenes: flip-TTA, low-res
probes, the CRF with float32 backbone and float32 mean-field state, argmax
and confusion blocks. The CRF runs at the default point (ds=8 jbu4 cp5 m4,
int8 cache), at ``operating_point=safe`` (ds=4, phase-free mixed, cached)
and as the exact ds=1 CRF with the cache off (the streaming message).
Predictions agree on >= 99.9% of pixels; the confusion blocks have the
same total and an L1 difference <= 0.2% of it (the int8 roundings of the
CRF can land one step apart between frameworks, see test_torch_crf).
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu import inference as jinf
from depthg_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from depthg_tpu.models import featurizer as jfeat
from depthg_tpu.models import probes as jprobes
from depthg_tpu.models import vit as jvit
from depthg_tpu.ops import crf as jcrf
from depthg_tpu.utils.metrics import confusion_update as jconfusion
from depthg_tpu_torch import inference as tinf
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.models import vit as tvit
from depthg_tpu_torch.ops import crf as tcrf
from depthg_tpu_torch.utils.ckpt import state_dict_from_jax
from depthg_tpu_torch.utils.metrics import compute_metrics, confusion_update

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "crf_fidelity_study",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "scripts", "crf_fidelity_study.py"))
fidelity = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fidelity)

VIT = dict(embed_dim=128, depth=2, num_heads=2, patch_size=8)


@pytest.fixture(scope="module")
def setup():
    fj = jfeat.FeaturizerConfig(vit_config=jvit.ViTConfig(**VIT), dim=16)
    ft = tfeat.FeaturizerConfig(vit_config=tvit.ViTConfig(**VIT), dim=16)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
    params = {"net": jfeat.featurizer_init(k1, fj),
              "linear_probe": jprobes.linear_probe_init(k2, 16, 5),
              "cluster_probe": jprobes.cluster_lookup_init(k3, 16, 7)}
    model = tinf.Segmenter.from_state_dict(state_dict_from_jax(params), ft)
    scenes = [fidelity.make_scene(64, 5, n_regions=6, seed=s) for s in (0, 1)]
    rgb = np.stack([s[0] for s in scenes]) / 255.0
    img = ((rgb - np.asarray(IMAGENET_MEAN)[None, :, None, None])
           / np.asarray(IMAGENET_STD)[None, :, None, None]).astype(np.float32)
    label = np.stack([s[1] for s in scenes]).astype(np.int32)
    label[:, :4] = -1  # unlabeled rows are masked out of the confusion
    return fj, params, model, img, label


def _configs(crf_cfg=None, kernel_cache_mb=2700, **kw):
    crf_cfg = crf_cfg or {}
    ej = jinf.EvalConfig(n_classes=5, extra_clusters=2, label_res=64,
                         crf=dataclasses.replace(jcrf.crf_config_from_cfg(crf_cfg),
                                                 dtype="float32",
                                                 kernel_cache_mb=kernel_cache_mb),
                         **kw)
    et = tinf.EvalConfig(n_classes=5, extra_clusters=2, label_res=64,
                         crf=dataclasses.replace(tcrf.crf_config_from_cfg(crf_cfg),
                                                 dtype="float32",
                                                 kernel_cache_mb=kernel_cache_mb),
                         **kw)
    return ej, et


def test_predictions_match_jax(setup):
    fj, params, model, img, _ = setup
    ej, et = _configs()
    lin_j, clu_j = jax.jit(lambda p, x: jinf.predictions(p, x, fj, ej))(
        params, jnp.asarray(img))
    lin_t, clu_t = tinf.make_predict_step(et)(model, torch.from_numpy(img))
    assert lin_t.dtype == torch.int32 and lin_t.shape == (2, 64, 64)
    assert (lin_t.numpy() == np.asarray(lin_j)).mean() >= 0.999
    assert (clu_t.numpy() == np.asarray(clu_j)).mean() >= 0.999


def test_eval_step_confusion_matches_jax(setup):
    _check_eval_step(setup)


@pytest.mark.parametrize("crf_cfg,kernel_cache_mb", [
    (jcrf.EVAL_OPERATING_POINTS["safe"], 2700),
    ({"crf_downsample": 1}, 0),  # the exact CRF, streaming as at 320 px
], ids=["safe", "exact_ds1"])
def test_eval_step_other_points_match_jax(setup, crf_cfg, kernel_cache_mb):
    _check_eval_step(setup, crf_cfg, kernel_cache_mb)


def _check_eval_step(setup, crf_cfg=None, kernel_cache_mb=2700):
    fj, params, model, img, label = setup
    ej, et = _configs(crf_cfg, kernel_cache_mb)
    stats_j = jinf.make_eval_step(fj, ej)(params, jnp.asarray(img),
                                          jnp.asarray(label))
    stats_t = tinf.make_eval_step(et)(model, torch.from_numpy(img),
                                      torch.from_numpy(label))
    for sj, st in zip(stats_j, stats_t):
        sj, st = np.asarray(sj).astype(np.int64), st.numpy()
        assert st.shape == sj.shape
        assert st.sum() == sj.sum()
        assert np.abs(st - sj).sum() <= 0.002 * sj.sum()
    lin, _ = compute_metrics(stats_t[0].numpy(), 5, 0, False)
    clu, _ = compute_metrics(stats_t[1].numpy(), 5, 2, True)
    assert np.isfinite(lin["Accuracy"]) and np.isfinite(clu["Accuracy"])


@pytest.mark.parametrize("extra", [0, 3])
def test_confusion_update_matches_jax(extra):
    rng = np.random.default_rng(extra)
    preds = rng.integers(-1, 5 + extra, (3, 17, 19)).astype(np.int32)
    target = rng.integers(-1, 6, (3, 17, 19)).astype(np.int32)  # 5 = out of range
    ref = np.asarray(jconfusion(jnp.asarray(preds), jnp.asarray(target), 5, extra))
    out = confusion_update(torch.from_numpy(preds), torch.from_numpy(target), 5, extra)
    np.testing.assert_array_equal(out.numpy(), ref)


def _coco_val(root, n=4, size=48):
    from PIL import Image

    rng = np.random.default_rng(0)
    base = os.path.join(root, "cocostuff")
    names = [f"val{i}" for i in range(n)]
    for sub in ("curated", "images", "annotations"):
        os.makedirs(os.path.join(base, sub, "val2017"), exist_ok=True)
    for lst in ("Coco164kFull_Stuff_Coarse.txt", "Coco164kFull_Stuff_Coarse_7.txt"):
        with open(os.path.join(base, "curated", "val2017", lst), "w") as f:
            f.write("\n".join(names))
    for name in names:
        Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8)).save(
            os.path.join(base, "images", "val2017", name + ".jpg"))
        Image.fromarray(rng.integers(0, 182, (size, size)).astype(np.uint8)).save(
            os.path.join(base, "annotations", "val2017", name + ".png"))


def test_eval_cli_on_cpu(tmp_path):
    """The port's entry module end to end on a tiny synthetic COCO val set:
    Lightning .ckpt in, metrics JSON and prediction PNGs out."""
    _run_eval_cli(tmp_path, "operating_point=default", predictions=True)


@pytest.mark.parametrize("point", ["operating_point=safe", "operating_point=quality_plus",
                                   "operating_point=fast", "crf_downsample=1",
                                   "crf_mixed_resolution=False", "crf_kernel_int8=False"])
def test_eval_cli_other_points_on_cpu(tmp_path, point):
    """The same CLI at the other CRF points a user can ask for."""
    _run_eval_cli(tmp_path, point, predictions=False)


def _run_eval_cli(tmp_path, point, predictions):
    import json

    from depthg_tpu_torch import eval_segmentation

    _coco_val(str(tmp_path))
    run_cfg = {"model_type": "vit_tiny", "dim": 16, "dataset_name": "cocostuff27",
               "n_classes": 27, "extra_clusters": 0, "res": 32}
    fcfg = tfeat.FeaturizerConfig(arch="vit_tiny", dim=16)
    model = tinf.Segmenter(fcfg, 27, 27).init_weights(torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "tiny.ckpt")
    torch.save({"state_dict": model.state_dict(),
                "hyper_parameters": {"cfg": run_cfg}}, ckpt)
    out_root = str(tmp_path / "out")
    metrics = eval_segmentation.main([
        f"data_dir={tmp_path}", f"output_root={out_root}", f"model_paths=[{ckpt}]",
        "res=32", "batch_size=1", "num_workers=1", "device=cpu",
        f"run_prediction={predictions}", "experiment_name=tiny", point])
    vals = metrics[ckpt]
    assert vals["n_images"] == 4 and vals["device"] == "cpu"
    assert np.isfinite(vals["final/linear/Accuracy"])
    assert np.isfinite(vals["final/cluster/Accuracy"])
    with open(os.path.join(out_root, "eval_metrics.json")) as f:
        assert json.load(f)[ckpt]["n_images"] == 4
    assert os.path.exists(os.path.join(out_root, "predictions", "tiny",
                                       "cluster", "0.png")) == predictions


def test_config_builders_match_jax(setup):
    """fcfg_from_run_cfg / ecfg_from_checkpoint resolve like the JAX
    package's (incl. its fused_tta=True and bf16 backbone defaults, and the
    config types of arch=dino_depth and arch=feature-pyramid)."""
    from depthg_tpu.config import Config, load_config
    from depthg_tpu.utils import checkpoint_io as jio

    _, params, model, _, _ = setup
    run_cfg = Config({"model_type": "vit_small", "dim": 32, "n_classes": 5})
    cfg = load_config("eval_config.yml", ["crf_coarse_prefix=3"])
    fj, ft = jio.fcfg_from_run_cfg(run_cfg), tinf.fcfg_from_run_cfg(run_cfg)
    for f in dataclasses.fields(ft):
        assert getattr(ft, f.name) == getattr(fj, f.name), f.name
    ej = jio.ecfg_from_checkpoint(cfg, params, run_cfg)
    et = tinf.ecfg_from_checkpoint(cfg, model.state_dict(), run_cfg)
    for f in dataclasses.fields(et):
        if f.name != "crf":
            assert getattr(et, f.name) == getattr(ej, f.name), f.name
    for f in dataclasses.fields(et.crf):
        assert getattr(et.crf, f.name) == getattr(ej.crf, f.name), f.name
    assert et.extra_clusters == 2 and et.fused_tta
    # the depth-fused and pyramid featurizers resolve to their own config
    # types, field for field as the JAX package's
    for arch in ("dino_depth", "feature-pyramid"):
        cfg_arch = Config({"arch": arch, "model_type": "vit_small", "dim": 32,
                           "guidance": "cross_attn", "granularity": 4, "continuous": False})
        fj, ft = jio.fcfg_from_run_cfg(cfg_arch), tinf.fcfg_from_run_cfg(cfg_arch)
        assert type(ft).__name__ == type(fj).__name__ != "FeaturizerConfig"
        for f in dataclasses.fields(ft):
            assert getattr(ft, f.name) == getattr(fj, f.name), (arch, f.name)


@pytest.mark.parametrize("flags,keys", [
    *[([f"operating_point={name}"], tcrf.EVAL_OPERATING_POINTS[name])
      for name in sorted(tcrf.EVAL_OPERATING_POINTS)],
    (["crf_downsample=1"], {"crf_downsample": 1}),
    (["crf_kernel_int8=False"], {"crf_kernel_int8": False}),
    (["operating_point=quality_plus", "crf_downsample=2"], {"crf_downsample": 2}),
    (["crf_downsample=2", "operating_point=quality_plus"], {"crf_downsample": 2}),
])
def test_eval_config_resolves_crf_points(flags, keys):
    """The eval CLI's ``eval_config`` (eval_config.yml, ``operating_point``
    expanded ahead of the other flags, explicit crf_* keys winning) resolves
    the CRF point that the same keys give ``crf_config_from_cfg`` directly
    (as chip_smoke.py passes them), and the one the JAX package's eval
    script resolves from the same flags."""
    from depthg_tpu.config import load_config
    from depthg_tpu_torch.eval_segmentation import eval_config

    port = tcrf.crf_config_from_cfg(eval_config(flags))
    assert port == tcrf.crf_config_from_cfg(keys)
    point = [f.split("=", 1)[1] for f in flags if f.startswith("operating_point=")]
    jflags = (jcrf.operating_point_overrides(point[0]) if point else []) + [
        f for f in flags if not f.startswith("operating_point=")]
    ref = jcrf.crf_config_from_cfg(load_config("eval_config.yml", jflags))
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
