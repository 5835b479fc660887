"""The port's own copies of the JAX package's numpy-only layers.

``depthg_tpu_torch`` imports nothing of ``depthg_tpu``; it keeps its own
config system (``config.py`` + ``configs/eval_config.yml``), data pipeline
(``data/``) and Lightning exporter (``utils/ckpt.py``). Each copy is held
here against its original on the same inputs, exactly: same resolved config
dict, same state-dict keys, shapes and values, same first batch.
"""

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
    package's batches, exactly, on a tiny synthetic COCO val set."""
    _coco_val(str(tmp_path))
    jds, jlen, ref = _first_batches(jdata, jconfig, str(tmp_path), crop)
    tds, tlen, out = _first_batches(tdata, tconfig, str(tmp_path), crop)
    assert len(tds) == len(jds) == 5 and tlen == jlen == 3
    assert tds.n_classes == jds.n_classes == 27
    for b_out, b_ref in zip(out, ref):
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


def test_package_never_calls_the_library_attention():
    """``scaled_dot_product_attention`` is the yardstick ``chip_smoke.py``
    times beside the kernel; no source of the package names it."""
    pkg = os.path.join(ROOT, "depthg_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(dirpath, name)) as f:
                    assert "scaled_dot_product_attention" not in f.read(), name
