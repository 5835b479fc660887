"""The port's own copies of the JAX package's numpy-only layers.

``depthg_tpu_torch`` imports nothing of ``depthg_tpu``; it keeps its own
config system (``config.py`` + ``configs/eval_config.yml``), data pipeline
(``data/``) and Lightning exporter (``utils/ckpt.py``). Each copy is held
here against its original on the same inputs, exactly: same resolved config
dict, same state-dict keys, shapes and values, same first batch.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from depthg_tpu import config as jconfig
from depthg_tpu import data as jdata
from depthg_tpu.data import loader as jloader
from depthg_tpu.utils import ckpt as jckpt
from depthg_tpu_torch import config as tconfig
from depthg_tpu_torch import data as tdata
from depthg_tpu_torch.data import loader as tloader
from depthg_tpu_torch.utils import ckpt as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [
    [],
    ["res=224", "batch_size=4"],
    ["--res", "224", "--experiment_name", "x y"],
    ["lr=5e-4", "--wd", "1e-5", "optim.eps=1.5E-8"],
    ["operating_point=safe", "crf_downsample=4", "--crf_dtype", "float32"],
    ["model_paths=[a.ckpt, b.ckpt]", "run_crf=False", "n_devices=~", "nested.key.deep=3"],
])
def test_load_config_matches_jax_package(argv):
    """Both argv styles, floats like 5e-4, lists, nulls and dotted keys
    resolve ``eval_config.yml`` to the same dict in both packages."""
    ref = jconfig.load_config("eval_config.yml", jconfig.cli_overrides(argv))
    out = tconfig.load_config("eval_config.yml", tconfig.cli_overrides(argv))
    assert tconfig.cli_overrides(argv) == jconfig.cli_overrides(argv)
    assert dict(out) == dict(ref)
    assert out.to_yaml() == ref.to_yaml()
    for key in ("lr", "wd"):
        if key in out:
            assert isinstance(out[key], float)


def test_eval_config_file_is_the_ports_own():
    """The port reads its own ``configs/eval_config.yml``, whose keys and
    values are those of the JAX package's file."""
    assert os.path.samefile(tconfig._CONFIG_DIR,
                            os.path.join(ROOT, "depthg_tpu_torch", "configs"))
    assert dict(tconfig.load_config("eval_config.yml")) == dict(
        jconfig.load_config("eval_config.yml"))


@pytest.mark.parametrize("name", ["local_config.yml", "train_config.yml",
                                  "serve_config.yml", "demo_config.yml"])
def test_train_config_files_held_exactly(name):
    """The trainer's, the server's and the demo's config files are
    byte-for-byte copies, and resolve to the same dict with trainer-style
    overrides."""
    with open(os.path.join(ROOT, "depthg_tpu", "configs", name), "rb") as f:
        ref_bytes = f.read()
    with open(os.path.join(ROOT, "depthg_tpu_torch", "configs", name), "rb") as f:
        assert f.read() == ref_bytes
    argv = ["lr=5e-4", "--batch_size", "8", "n_devices=~", "depth_feat_weight=0.19"]
    ref = jconfig.load_config(name, jconfig.cli_overrides(argv))
    out = tconfig.load_config(name, tconfig.cli_overrides(argv))
    assert dict(out) == dict(ref) and out.n_devices is None and out.lr == 5e-4


def test_config_attribute_access_and_errors():
    cfg = tconfig.load_config("eval_config.yml", ["a.b=1"])
    assert cfg.a.b == 1 and cfg.get_path("a.b") == 1 and cfg.get_path("a.c", 7) == 7
    with pytest.raises(AttributeError):
        cfg.missing
    with pytest.raises(ValueError, match="missing a value"):
        tconfig.cli_overrides(["--res"])
    with pytest.raises(ValueError, match="Unexpected arg"):
        tconfig.cli_overrides(["res"])


def _param_tree(seed, depth=2, d=32, ps=4, dim=8, n_classes=5, decoder=True):
    """The JAX package's segmenter parameter tree as seeded numpy arrays."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def dense(i, o):
        return {"w": arr(i, o), "b": arr(o)}

    def norm():
        return {"g": arr(d), "b": arr(d)}

    vit = {"patch_embed": dense(3 * ps * ps, d), "cls_token": arr(1, 1, d),
           "pos_embed": arr(1, 17, d), "norm": norm(),
           "blocks": [{"norm1": norm(), "qkv": dense(d, 3 * d), "proj": dense(d, d),
                       "norm2": norm(), "fc1": dense(d, 4 * d), "fc2": dense(4 * d, d)}
                      for _ in range(depth)]}
    tree = {"net": {"vit": vit, "cluster1": dense(d, dim),
                    "cluster2": {"fc1": dense(d, d), "fc2": dense(d, dim)}},
            "linear_probe": dense(dim, n_classes),
            "cluster_probe": {"clusters": arr(n_classes + 2, dim)}}
    if decoder:
        tree["decoder"] = dense(dim, d)
    return tree


@pytest.mark.parametrize("decoder", [True, False])
def test_lightning_state_dict_matches_jax_package(decoder):
    """The port's exporter gives the JAX package's keys, shapes and values."""
    tree = _param_tree(0, decoder=decoder)
    ref = jckpt.lightning_state_dict(tree)
    out = tckpt.lightning_state_dict(tree)
    assert list(out) == list(ref)
    for key in ref:
        assert out[key].shape == ref[key].shape and out[key].dtype == ref[key].dtype, key
        assert torch.equal(out[key], ref[key]), key
    assert ("decoder.weight" in out) == decoder


def test_state_dict_from_jax_runs_on_the_ports_exporter():
    """``state_dict_from_jax`` is the eval subset of the port's own exporter
    (float32, the decoder dropped), equal to the JAX package's export."""
    tree = _param_tree(1)
    sd = tckpt.state_dict_from_jax(tree)
    ref = jckpt.lightning_state_dict(tree)
    assert set(sd) == {k for k in ref if k.startswith(tckpt.EVAL_PREFIXES)}
    assert not any(k.startswith("decoder") for k in sd)
    for key, val in sd.items():
        assert val.dtype == torch.float32 and torch.equal(val, ref[key].float()), key
    assert sd["linear_probe.weight"].dim() == 4


def test_state_dict_from_jax_keeps_the_decoder_on_request():
    """``keep_decoder=True`` (the train state's carry-over) adds exactly the
    decoder's keys."""
    tree = _param_tree(2)
    sd = tckpt.state_dict_from_jax(tree)
    full = tckpt.state_dict_from_jax(tree, keep_decoder=True)
    assert set(full) - set(sd) == {"decoder.weight", "decoder.bias"}
    ref = jckpt.lightning_state_dict(tree)
    for key, val in full.items():
        assert torch.equal(val, ref[key].float()), key
    assert set(tckpt.state_dict_from_jax(_param_tree(2, decoder=False),
                                         keep_decoder=True)) == set(sd)


def test_export_lightning_ckpt_matches_jax_package(tmp_path):
    """The port's exporter writes the JAX package's blob: same top-level
    keys, hyper-parameters and state dict."""
    tree = _param_tree(3)
    cfg = {"model_type": "vit_small", "dim": 8}
    jckpt.export_lightning_ckpt(str(tmp_path / "j.ckpt"), tree, cfg=cfg, global_step=7)
    tckpt.export_lightning_ckpt(str(tmp_path / "t.ckpt"), tckpt.lightning_state_dict(tree),
                                cfg=cfg, global_step=7)
    ref = torch.load(str(tmp_path / "j.ckpt"), weights_only=False)
    out = torch.load(str(tmp_path / "t.ckpt"), weights_only=False)
    assert list(out) == list(ref)
    for key in ref:
        if key != "state_dict":
            assert out[key] == ref[key], key
    assert list(out["state_dict"]) == list(ref["state_dict"])
    for key, val in ref["state_dict"].items():
        assert torch.equal(out["state_dict"][key], val), key


def test_load_dino_pth_matches_jax_package(tmp_path):
    """A wrapped DINO ``.pth`` read by both loaders gives the same ViT."""
    tree = _param_tree(4)
    vit_sd = tckpt.vit_state_dict(tree["net"]["vit"])
    path = str(tmp_path / "dino.pth")
    torch.save({"teacher": {"module.backbone." + k: v for k, v in vit_sd.items()}}, path)
    out = tckpt.load_dino_pth(path)
    assert sorted(out) == sorted(vit_sd)
    back = tckpt.vit_state_dict(jckpt.load_dino_pth(path))
    for key, val in out.items():
        assert torch.equal(val, vit_sd[key]) and torch.equal(back[key], val), key


def _coco_val(root, n=5, size=40):
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
        Image.fromarray(rng.integers(0, 255, (size, size + 8, 3), np.uint8)).save(
            os.path.join(base, "images", "val2017", name + ".jpg"))
        Image.fromarray(rng.integers(0, 182, (size, size + 8)).astype(np.uint8)).save(
            os.path.join(base, "annotations", "val2017", name + ".png"))


def _first_batches(pkg_data, pkg_config, root, crop, n_batches=2):
    run_cfg = pkg_config.Config({"dataset_name": "cocostuff27", "res": 32})
    dataset = pkg_data.ContrastiveSegDataset(
        data_dir=root, dataset_name="cocostuff27", crop_type=None, image_set="val",
        transform=pkg_data.get_transform(32, False, crop),
        target_transform=pkg_data.get_transform(32, True, crop), cfg=run_cfg, mask=True)
    loader = pkg_data.DataLoader(dataset, 2, shuffle=False, num_workers=2)
    batches = []
    for batch in loader:
        batches.append(batch)
        if len(batches) == n_batches:
            break
    return dataset, len(loader), batches


@pytest.mark.parametrize("crop", ["center", None])
def test_dataset_and_loader_match_jax_package(tmp_path, crop):
    """``ContrastiveSegDataset`` (val) + ``DataLoader`` give the JAX
    package's batches, exactly, on a tiny synthetic COCO val set (plus the
    port's ``n_real``)."""
    _coco_val(str(tmp_path))
    jds, jlen, ref = _first_batches(jdata, jconfig, str(tmp_path), crop)
    tds, tlen, out = _first_batches(tdata, tconfig, str(tmp_path), crop)
    assert len(tds) == len(jds) == 5 and tlen == jlen == 3
    assert tds.n_classes == jds.n_classes == 27
    for b_out, b_ref in zip(out, ref):
        # the port's batches also carry the global batch's count of real items
        assert b_out.pop("n_real") == len(b_ref["img"])
        assert sorted(b_out) == sorted(b_ref)
        assert {"img", "label"} <= set(b_out)
        for key in b_ref:
            if isinstance(b_ref[key], np.ndarray):
                assert b_out[key].dtype == b_ref[key].dtype, key
                np.testing.assert_array_equal(b_out[key], b_ref[key], err_msg=key)
            else:
                assert b_out[key] == b_ref[key], key


def test_colormaps_and_statistics_match_jax_package():
    from depthg_tpu.data import datasets as jds
    from depthg_tpu_torch.data import datasets as tds

    np.testing.assert_array_equal(tds.create_pascal_label_colormap(),
                                  jds.create_pascal_label_colormap())
    np.testing.assert_array_equal(tds.create_cityscapes_colormap(),
                                  jds.create_cityscapes_colormap())
    assert tuple(tdata.IMAGENET_MEAN) == tuple(jdata.IMAGENET_MEAN)
    assert tuple(tdata.IMAGENET_STD) == tuple(jdata.IMAGENET_STD)


def test_pack_batch_matches_jax_package():
    """The host half of the packed transfer is carried over unchanged; its
    device half (a JAX function) is not part of the port."""
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (2, 3, 8, 8)).astype(np.float32) / 255.0
    mean = np.asarray(tdata.IMAGENET_MEAN, np.float32)[:, None, None]
    std = np.asarray(tdata.IMAGENET_STD, np.float32)[:, None, None]
    batch = {"img": (u8 - mean) / std, "label": rng.integers(-1, 27, (2, 8, 8)),
             "depth": rng.standard_normal((2, 8, 8)).astype(np.float32),
             "mask": rng.integers(0, 2, (2, 8, 8)).astype(bool)}
    (f_ref, u_ref), spec_ref = jloader.pack_batch(batch, batch.keys())
    (f_out, u_out), spec_out = tloader.pack_batch(batch, batch.keys())
    assert spec_out == spec_ref
    np.testing.assert_array_equal(f_out, f_ref)
    np.testing.assert_array_equal(u_out, u_ref)
    assert not hasattr(tloader, "unpack_batch")


def _load_script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"depthg_scripts_{name}", os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script,names", [
    ("serve_loadgen", ["run", "main"]),
    ("crop_datasets", ["five_crop_np", "random_crops_np", "to_uint8_img",
                       "process_dataset", "main"]),
])
def test_stdlib_and_numpy_scripts_are_carried_over_unchanged(script, names):
    """The load generator (stdlib only) and the crop CLI (numpy + PIL over
    the port's own ``data/``) are copies: every function has the source of
    the JAX package's script."""
    import importlib
    import inspect

    ref = _load_script(script)
    out = importlib.import_module(f"depthg_tpu_torch.{script}")
    for name in names:
        assert inspect.getsource(getattr(out, name)) == inspect.getsource(getattr(ref, name)), name
    functions = {n for n, f in vars(ref).items()
                 if inspect.isfunction(f) and f.__module__ == ref.__name__}
    assert functions == set(names)
    if script == "crop_datasets":
        assert out.ContrastiveSegDataset.__module__.startswith("depthg_tpu_torch.")
        assert out.RawTransform.__module__.startswith("depthg_tpu_torch.")


def test_serve_batcher_is_carried_over_unchanged():
    """The batcher, its metrics, the buckets and the HTTP front end are pure
    Python threading and stdlib: the port's source is the JAX package's."""
    import inspect

    from depthg_tpu import serve as jserve
    from depthg_tpu_torch import serve as tserve

    for name in ("_Pending", "BatcherMetrics", "DynamicBatcher", "_encode_response",
                 "serve_http"):
        assert inspect.getsource(getattr(tserve, name)) == inspect.getsource(
            getattr(jserve, name)), name


def test_package_never_calls_the_library_attention():
    """``scaled_dot_product_attention`` is the yardstick ``chip_smoke.py``
    times beside the kernel; no source of the package names it."""
    pkg = os.path.join(ROOT, "depthg_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(dirpath, name)) as f:
                    assert "scaled_dot_product_attention" not in f.read(), name


@pytest.mark.parametrize("h,w", [(3, 3), (4, 6), (24, 24), (24, 32), (32, 24)])
def test_relative_position_index_matches_jax_package(h, w):
    from depthg_tpu.models.zoedepth.beit import relative_position_index as jindex
    from depthg_tpu_torch.models.zoedepth.beit import relative_position_index as tindex

    out, ref = tindex(h, w), jindex(h, w)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def test_prep_size_matches_jax_package():
    from depthg_tpu.models.zoedepth.model import ZoeConfig as JZoe
    from depthg_tpu.models.zoedepth.model import prep_size as jprep
    from depthg_tpu_torch.models.zoedepth.model import ZoeConfig as TZoe
    from depthg_tpu_torch.models.zoedepth.model import prep_size as tprep

    for h, w in ((384, 512), (466, 608), (608, 466), (466, 466), (480, 640), (1, 1), (1000, 37)):
        assert tprep(h, w, TZoe()) == jprep(h, w, JZoe()), (h, w)


def test_iter_images_matches_the_jax_script(tmp_path):
    """``generate_depth.iter_images`` over an image folder and over the
    port's own COCO reader: the same images (pixels) and naming paths as
    ``scripts/generate_depth.py``'s."""
    import argparse

    from PIL import Image

    from depthg_tpu_torch import generate_depth as tgd

    ref_mod = _load_script("generate_depth")
    folder = tmp_path / "folder"
    rng = np.random.default_rng(5)
    for sub, n in (("b", 2), ("a", 3)):
        (folder / sub).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (20 + i, 30, 3), np.uint8)).save(
                folder / sub / f"x{i}.png")
    (folder / "not_a_dir.txt").write_text("skipped")
    _coco_val(str(tmp_path / "coco"))
    for dataset, data_dir, split in (("imagefolder", folder, "val"),
                                     ("cocostuff", tmp_path / "coco", "val")):
        args = argparse.Namespace(dataset=dataset, data_dir=str(data_dir), split=split)
        out, ref = list(tgd.iter_images(args)), list(ref_mod.iter_images(args))
        assert len(out) == len(ref) > 0
        for (img, path), (rimg, rpath) in zip(out, ref):
            assert path == rpath
            np.testing.assert_array_equal(np.asarray(img), np.asarray(rimg))


@pytest.mark.parametrize("size,seed", [(64, 0), (96, 3), (160, 1), (320, 5)])
def test_fidelity_scene_and_metric_copies_match_the_jax_script(size, seed):
    """``make_scene`` and ``miou_acc`` of the port's fidelity study are
    copies of ``scripts/crf_fidelity_study.py``'s: the same arrays and the
    same mIoU / accuracy floats."""
    from depthg_tpu_torch import crf_fidelity_study as study

    ref_mod = _load_script("crf_fidelity_study")
    out, ref = study.make_scene(size, 27, seed=seed), ref_mod.make_scene(size, 27, seed=seed)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    pred = np.random.default_rng(seed).integers(0, 27, out[1].shape)
    for p in (pred, out[1], out[2].argmax(0).repeat(8, 0).repeat(8, 1)):
        assert study.miou_acc(p, out[1], 27) == ref_mod.miou_acc(p, ref[1], 27)


def test_native_crf_copy_matches_jax_package():
    """The port's ``native_crf`` gives the JAX package's refined Q on one
    small scene, exactly."""
    from depthg_tpu import native_crf as jnative
    from depthg_tpu_torch import crf_fidelity_study as study
    from depthg_tpu_torch import native_crf as tnative

    image, _, logits = study.make_scene(64, 27, seed=2)
    probs = np.exp(logits.repeat(8, 1).repeat(8, 2))
    probs /= probs.sum(0, keepdims=True)
    out = tnative.dense_crf_native(image, probs)
    np.testing.assert_array_equal(out, jnative.dense_crf_native(image, probs))
    assert out.shape == probs.shape and np.allclose(out.sum(0), 1.0, atol=1e-4)


def test_native_crf_builds_its_own_library_when_the_committed_one_fails(tmp_path, monkeypatch):
    """A committed library that does not load is rebuilt with g++ under the
    build directory (never under ``native/``), giving the same Q; a failed
    build raises."""
    from depthg_tpu_torch import crf_fidelity_study as study
    from depthg_tpu_torch import native_crf as tnative

    image, _, logits = study.make_scene(64, 27, seed=4)
    probs = np.exp(logits.repeat(8, 1).repeat(8, 2))
    probs /= probs.sum(0, keepdims=True)
    ref = tnative.dense_crf_native(image, probs)
    broken = tmp_path / "libpermutocrf.so"
    broken.write_bytes(b"not a shared library")
    native_before = sorted(os.listdir(os.path.join(ROOT, "native", "crf")))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_LIB_PATH", str(broken))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    np.testing.assert_array_equal(tnative.dense_crf_native(image, probs), ref)
    assert os.listdir(tmp_path / "build") == ["libpermutocrf.so"]
    assert sorted(os.listdir(os.path.join(ROOT, "native", "crf"))) == native_before
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_SRC_DIR", str(tmp_path / "missing"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.dense_crf_native(image, probs)


# The fine-tune slice's copies: each file equals its original but for the
# lines named here (the imports that point at the port; the resize of the
# metrics and the readers is the port's numpy-in, numpy-out wrapper).
RESIZE_IMPORT = ("from depthg_tpu.ops.resize import resize_bilinear",
                 "from depthg_tpu_torch.ops.resize import resize_bilinear_array as resize_bilinear")
ZOE_COPIES = {
    "models/zoedepth/metrics.py": [RESIZE_IMPORT],
    "models/zoedepth/eval_datasets.py": [RESIZE_IMPORT],
    "models/zoedepth/data_mono.py": [
        ("from depthg_tpu.models.zoedepth.config import",
         "from depthg_tpu_torch.models.zoedepth.config import")],
    "models/zoedepth/config.py": [
        ("from depthg_tpu.models.zoedepth.model import ZoeConfig",
         "from depthg_tpu_torch.models.zoedepth.model import ZoeConfig"),
        ("from depthg_tpu.models.zoedepth.nk import", "from depthg_tpu_torch.models.zoedepth.nk import")],
    "data/nyuv2_prep.py": [],
}


@pytest.mark.parametrize("rel", sorted(ZOE_COPIES))
def test_zoedepth_copies_equal_their_originals(rel):
    with open(os.path.join(ROOT, "depthg_tpu", rel)) as f:
        want = f.read()
    for old, new in ZOE_COPIES[rel]:
        assert old in want, (rel, old)
        want = want.replace(old, new)
    with open(os.path.join(ROOT, "depthg_tpu_torch", rel)) as f:
        assert f.read() == want, rel


def test_depth_dataset_tables_match_jax_package():
    """Every ``DepthDatasetSpec`` field by field, the dataset lists, the
    reference-shaped dicts (with and without a data root), the model
    blocks and the pretrained URLs (strings only: nothing is fetched)."""
    from depthg_tpu.models.zoedepth import config as jc
    from depthg_tpu_torch.models.zoedepth import config as tc

    assert list(tc.DEPTH_DATASETS) == list(jc.DEPTH_DATASETS) and len(tc.DEPTH_DATASETS) == 13
    for name, spec in jc.DEPTH_DATASETS.items():
        assert dataclasses.asdict(tc.DEPTH_DATASETS[name]) == dataclasses.asdict(spec), name
        for root in (None, "/data"):
            assert tc.datasets_config(name, root) == jc.datasets_config(name, root), name
    assert (tc.ALL_INDOOR, tc.ALL_OUTDOOR, tc.ALL_EVAL_DATASETS) == (
        jc.ALL_INDOOR, jc.ALL_OUTDOOR, jc.ALL_EVAL_DATASETS)
    assert tc.ZOEDEPTH_MODEL_CONFIG == jc.ZOEDEPTH_MODEL_CONFIG
    assert tc.ZOEDEPTH_NK_MODEL_CONFIG == jc.ZOEDEPTH_NK_MODEL_CONFIG
    assert tc.PRETRAINED_RESOURCES == jc.PRETRAINED_RESOURCES


@pytest.mark.parametrize("model", ["zoedepth", "zoedepth_nk"])
@pytest.mark.parametrize("mode", ["train", "infer", "eval"])
@pytest.mark.parametrize("over", [{}, {"n_bins": 32, "img_size": 256, "n_attractors": [8, 4, 2, 1],
                                       "min_temp": 0.5, "unknown_key": 1}])
def test_get_config_matches_jax_package(model, mode, over):
    """Field by field, for both models and all three modes, with and without
    overrides. Two differences are the port's own: BEiT's ``attn_impl``
    (the port's "auto", the JAX package's "xla") and ``DPTConfig``'s
    ``project_readout`` (the port also loads MiDaS files without a readout
    projection; True is the JAX package's only behaviour)."""
    from depthg_tpu.models.zoedepth import config as jc
    from depthg_tpu_torch.models.zoedepth import config as tc

    ref = dataclasses.asdict(jc.get_config(model, mode, **over))
    got = dataclasses.asdict(tc.get_config(model, mode, **over))
    assert (ref["beit"].pop("attn_impl"), got["beit"].pop("attn_impl")) == ("xla", "auto")
    assert got["dpt"].pop("project_readout") is True
    assert got == ref
    with pytest.raises(ValueError):
        tc.get_config(model, "serve")


def _zoe_layout(root, n=4, hw=(48, 64), seed=0):
    from test_zoedepth_data import _make_layout

    return _make_layout(str(root), n=n, hw=hw, seed=seed)


@pytest.mark.parametrize("aug", [True, False])
def test_zoe_data_samples_match_jax_package(tmp_path, aug):
    """``DataLoadPreprocess`` train samples (rotation, random crop, flip and
    photometric augmentation drawn from (seed, index)) and online_eval
    samples equal to the JAX package's, array for array, and the batches of
    ``batched`` in one permutation."""
    from depthg_tpu.models.zoedepth import data_mono as jdm
    from depthg_tpu_torch.models.zoedepth import data_mono as tdm

    fn = _zoe_layout(tmp_path)
    kw = dict(dataset="nyu", data_path=str(tmp_path), gt_path=str(tmp_path),
              data_path_eval=str(tmp_path), gt_path_eval=str(tmp_path), filenames_file=fn,
              filenames_file_eval=fn, input_height=32, input_width=48, degree=2.5, aug=aug,
              random_crop=True, seed=7)
    for mode in ("train", "online_eval"):
        ref = jdm.DataLoadPreprocess(jdm.MonoDepthDataConfig(**kw), mode)
        got = tdm.DataLoadPreprocess(tdm.MonoDepthDataConfig(**kw), mode)
        assert len(got) == len(ref) == 4
        for i in range(4):
            a, b = got[i], ref[i]
            assert sorted(a) == sorted(b), (mode, i)
            for k in b:
                if isinstance(b[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{mode} {i} {k}")
                else:
                    assert a[k] == b[k], (mode, i, k)
    order = np.random.default_rng(0).permutation(4)
    ds_t = tdm.DataLoadPreprocess(tdm.MonoDepthDataConfig(**kw), "train")
    ds_j = jdm.DataLoadPreprocess(jdm.MonoDepthDataConfig(**kw), "train")
    for bt, bj in zip(tdm.batched(ds_t, 2, order), jdm.batched(ds_j, 2, order)):
        np.testing.assert_array_equal(bt["image"], bj["image"])
        np.testing.assert_array_equal(bt["mask"], bj["mask"])
    spec = tdm.MonoDepthDataConfig.for_dataset("kitti", "/data", filenames_file="f.txt")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jdm.MonoDepthDataConfig.for_dataset(
        "kitti", "/data", filenames_file="f.txt"))
    assert len(tdm.RepetitiveRoundRobinLoader([1, 2, 3], [4])) == 8


def test_zoe_metrics_match_jax_package():
    """``compute_metrics`` with each crop and clipping (an inf entry)
    exactly, and with a low-resolution prediction within 1e-5 relative: it
    is resized by ``F.interpolate``, which forms its source indices in
    float32, the JAX package by exact weight matrices (~5e-6 apart, enough
    to move a pixel across a delta threshold: 1 of ~238,000); and
    ``RunningAverageDict``."""
    from depthg_tpu.models.zoedepth import metrics as jm
    from depthg_tpu_torch.models.zoedepth import metrics as tm

    rng = np.random.default_rng(0)
    gt = rng.uniform(0.5, 9.0, (480, 640)).astype(np.float32)
    pred = (gt * rng.uniform(0.8, 1.25, gt.shape)).astype(np.float32)
    low = pred[::2, ::2].copy()
    pred[:3, :3] = np.inf
    for kw in ({"eigen_crop": True}, {"garg_crop": True, "eigen_crop": False},
               {"garg_crop": False, "eigen_crop": True, "dataset": "kitti"},
               {"eigen_crop": False, "min_depth_eval": 1.0, "max_depth_eval": 8.0}):
        assert tm.compute_metrics(gt, pred, **kw) == jm.compute_metrics(gt, pred, **kw)
        got, ref = tm.compute_metrics(gt, low, **kw), jm.compute_metrics(gt, low, **kw)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    r = tm.RunningAverageDict()
    for v in (1.0, None, 3.0):
        r.update(None if v is None else {"x": v})
    assert r.get_value() == {"x": 2.0}


def test_zoe_eval_readers_match_jax_package(tmp_path):
    """The readers' table, and a DIML indoor sample (PNG pair, resized to
    480 x 640: within 1e-5 absolute on [0, 1] pixels, ``F.interpolate``'s
    float32 source indices against the JAX package's exact weights) and an
    iBims sample (masks, exactly) against the JAX package's."""
    from depthg_tpu.models.zoedepth import eval_datasets as je
    from depthg_tpu_torch.models.zoedepth import eval_datasets as te
    from test_zoe_eval_readers import _png

    assert sorted(te.EVAL_READERS) == sorted(je.EVAL_READERS)
    rng = np.random.default_rng(0)
    _png(str(tmp_path / "diml" / "LR" / "s1" / "color" / "a_c.png"),
         rng.integers(0, 255, (96, 128, 3), dtype=np.uint8))
    _png(str(tmp_path / "diml" / "LR" / "s1" / "depth_filled" / "a_depth_filled.png"),
         rng.integers(500, 9000, (96, 128)).astype(np.uint16))
    ib = tmp_path / "ibims"
    _png(str(ib / "rgb" / "x.png"), rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
    _png(str(ib / "depth" / "x.png"), rng.integers(1000, 60000, (24, 32)).astype(np.uint16))
    _png(str(ib / "mask_invalid" / "x.png"), (rng.random((24, 32)) > 0.2).astype(np.uint8))
    _png(str(ib / "mask_transp" / "x.png"), (rng.random((24, 32)) > 0.1).astype(np.uint8))
    (ib / "imagelist.txt").write_text("x\n")
    for name, root, exact in (("diml_indoor", "diml", False), ("ibims", "ibims", True)):
        got = te.get_eval_reader(name, str(tmp_path / root))[0]
        ref = je.get_eval_reader(name, str(tmp_path / root))[0]
        assert sorted(got) == sorted(ref)
        for k in ref:
            if isinstance(ref[k], np.ndarray):
                if exact:
                    np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
                else:
                    np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5, err_msg=k)
            else:
                assert got[k] == ref[k], k


def test_figures_and_heatmap_are_copies():
    """``utils/figures.py`` is the JAX package's file byte for byte, and
    ``confusion_heatmap_png`` has its original's source; both write the
    same PNG."""
    import inspect

    from depthg_tpu.utils import metrics as jmetrics
    from depthg_tpu_torch.utils import metrics as tmetrics

    with open(os.path.join(ROOT, "depthg_tpu", "utils", "figures.py"), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "depthg_tpu_torch", "utils", "figures.py"), "rb") as f:
        assert f.read() == want
    assert (inspect.getsource(tmetrics.confusion_heatmap_png)
            == inspect.getsource(jmetrics.confusion_heatmap_png))


def test_variant_copies_equal_their_originals():
    """The variants slice's copies of numpy-only code: ``neighborhood_mask``
    (LHP), ``_pyramid_channels`` (the depth pyramid) and ``load_model``'s
    file table and ResNet-50 family hold the JAX package's source and
    values exactly."""
    import inspect

    from depthg_tpu.models import featurizer_depth as jfd
    from depthg_tpu.models import lhp as jlhp
    from depthg_tpu.models import pyramid as jpyr
    from depthg_tpu_torch.models import featurizer_depth as tfd
    from depthg_tpu_torch.models import lhp as tlhp
    from depthg_tpu_torch.models import pyramid as tpyr

    for ours, theirs in ((tlhp.neighborhood_mask, jlhp.neighborhood_mask),
                         (tfd._pyramid_channels, jfd._pyramid_channels)):
        assert inspect.getsource(ours) == inspect.getsource(theirs), ours.__name__
    for n in (1, 3, 5):
        np.testing.assert_array_equal(tlhp.neighborhood_mask(n), jlhp.neighborhood_mask(n))
    for nf in (64, 384, 768):
        assert tfd._pyramid_channels(nf) == jfd._pyramid_channels(nf)
    assert tpyr._MODEL_FILES == jpyr._MODEL_FILES
    assert tpyr.RESNET50_MODEL_TYPES == jpyr.RESNET50_MODEL_TYPES
    assert tpyr._R50_LAYERS == jpyr._R50_LAYERS and tpyr._VGG11_CFG == jpyr._VGG11_CFG
    assert (tpyr._DN121_BLOCKS, tpyr._DN_GROWTH) == (jpyr._DN121_BLOCKS, jpyr._DN_GROWTH)
    assert dataclasses.asdict(tpyr.PyramidConfig()) == dataclasses.asdict(jpyr.PyramidConfig())
    assert dataclasses.asdict(tlhp.LHPConfig()) == dataclasses.asdict(jlhp.LHPConfig())


def test_potsdam_ops_is_a_verbatim_copy(tmp_path):
    """``depthg_tpu_torch/potsdam_ops.py`` (numpy, PIL and scipy's
    ``loadmat``) is ``scripts/potsdam_ops.py`` byte for byte, and its three
    tasks write the same files: ``.mat`` tiles to PNGs, the depth maps'
    post-processing, and the exact-match renaming."""
    import argparse

    from PIL import Image
    from scipy.io import savemat

    from depthg_tpu_torch import potsdam_ops

    with open(os.path.join(ROOT, "scripts", "potsdam_ops.py"), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "depthg_tpu_torch", "potsdam_ops.py"), "rb") as f:
        assert f.read() == want
    ref = _load_script("potsdam_ops")
    rng = np.random.default_rng(0)
    mats, comp, renamed, depth = (tmp_path / d for d in ("mats", "comp", "renamed", "depth"))
    for d in (mats, comp, renamed, depth):
        d.mkdir()
    tiles = [rng.integers(0, 255, (8, 8, 4), np.uint8) for _ in range(2)]
    for i, tile in enumerate(tiles):
        savemat(mats / f"t{i}.mat", {"img": tile})
        savemat(comp / f"c{1 - i}.mat", {"img": tile})
        Image.fromarray(tile[:, :, :3]).save(renamed / f"c{1 - i}.png")
    for name in ("a_kbr.png", "b_midas.png", "c_zoedepth.png", "d_plain.png"):
        Image.fromarray(rng.integers(0, 255, (20, 30, 3), np.uint8)).save(depth / name)
    outs = {}
    for label, mod in (("ref", ref), ("port", potsdam_ops)):
        out = tmp_path / label
        args = argparse.Namespace(folder=str(mats), comp_folder=str(comp),
                                  rename_folder=str(renamed), output_dir=str(out / "png"))
        mod.convert_mat(args)
        args.output_dir = str(out / "matched")
        mod.match_images(args)
        mod.convert_coco_depth_map(argparse.Namespace(folder=str(depth)))
        os.replace(depth / "processed", out / "processed")
        outs[label] = {p.relative_to(out).as_posix(): p.read_bytes()
                       for p in sorted(out.rglob("*.png"))}
    assert outs["port"] == outs["ref"] and len(outs["ref"]) == 8


def test_profiling_step_timer_and_log_jsonl_are_copies(tmp_path):
    """``utils/profiling.py``'s ``StepTimer`` and ``log_jsonl`` (pure Python)
    have their originals' source, and write the same log."""
    import inspect

    from depthg_tpu.utils import profiling as jprof
    from depthg_tpu_torch.utils import profiling as tprof

    for name in ("StepTimer", "log_jsonl"):
        assert inspect.getsource(getattr(tprof, name)) == inspect.getsource(
            getattr(jprof, name)), name
    for mod, path in ((jprof, tmp_path / "j.jsonl"), (tprof, tmp_path / "t.jsonl")):
        mod.log_jsonl(str(path), {"step": 3, "img/s": 1.5})
    assert (tmp_path / "j.jsonl").read_bytes() == (tmp_path / "t.jsonl").read_bytes()
