"""``depthg_tpu_torch.generate_depth`` vs ``scripts/generate_depth.py``.

The bucketed pipeline with a stub model (the fixture of
``tests/test_generate_depth_pipeline.py``: five images of one size and two
of another, ``--batch_size 4``, so one full batch and two tails) writes the
same PNG and feature bytes as the JAX script's ``run_pipeline`` with the
same stub: the JAX script pads tails to a power of two and runs
data-parallel over the test mesh, the port runs tails at their own size,
and the output does not change. The stub computes one float32 addition, so
both frameworks round it alike. Then the MiDaS inversion, the refusals of
``main``, and ``main`` end to end on the CPU with a small ZoeDepth and a
small DPT_Large (``main``'s ``zoe_config`` / ``midas_config``), in float32
and with ``--dtype int8``.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from PIL import Image

from depthg_tpu_torch import generate_depth as tgd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "depthg_scripts_generate_depth", os.path.join(ROOT, "scripts", "generate_depth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    (root / "val").mkdir()
    rng = np.random.default_rng(0)
    sizes = [(96, 64)] * 5 + [(64, 96)] * 2
    for i, (w, h) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(root / "val" / f"im{i}.jpg")
    return root


def _argv(image_dir, out, model="zoedepth", batch=4, features=True):
    argv = ["--data_dir", str(image_dir), "--output_dir", str(out),
            "--batch_size", str(batch), "--model", model]
    return argv + (["--save_features"] if features else [])


def _files(folder):
    return {p.name: p.read_bytes() for p in sorted(folder.glob("*"))}


@pytest.mark.parametrize("model", ["zoedepth", "midas"])
def test_pipeline_writes_the_jax_scripts_bytes(image_dir, tmp_path, model):
    gd = _load_script()
    jargs = gd.get_args_parser().parse_args(_argv(image_dir, tmp_path / "jax", model))
    os.makedirs(jargs.output_dir)

    def jax_infer(p, x):
        d = x[:, :1] + x[:, 1:2]
        return d, d[:, :, ::2, ::2]

    gd.run_pipeline(jargs, jax_infer, params={})

    batches = []

    def infer(x):
        batches.append(tuple(x.shape))
        d = x[:, :1] + x[:, 1:2]
        return d, d[:, :, ::2, ::2]

    targs = tgd.get_args_parser().parse_args(_argv(image_dir, tmp_path / "port", model))
    assert tgd.run_pipeline(targs, infer, device=torch.device("cpu")) == 7
    # one full batch and two tails at their own size (no power-of-two padding)
    assert sorted(batches) == [(1, 3, 64, 96), (2, 3, 96, 64), (4, 3, 64, 96)]
    ref, got = _files(tmp_path / "jax" / "val"), _files(tmp_path / "port" / "val")
    assert sorted(got) == sorted(ref) and len(got) == 14
    for name in ref:
        assert got[name] == ref[name], name
    for name in (n for n in got if n.endswith(".png")):
        png = np.asarray(Image.open(tmp_path / "port" / "val" / name))
        assert png.dtype == np.uint8 and png.min() == 0 and png.max() == 255


def test_midas_output_is_inverted(image_dir, tmp_path):
    def infer(x):
        d = x[:, :1] + x[:, 1:2]
        return d, d

    for model in ("zoedepth", "midas"):
        args = tgd.get_args_parser().parse_args(
            _argv(image_dir, tmp_path / model, model, batch=2, features=False))
        tgd.run_pipeline(args, infer, device=torch.device("cpu"))
    a = np.asarray(Image.open(tmp_path / "zoedepth" / "val" / "im0_zoedepth.png"), np.int32)
    b = np.asarray(Image.open(tmp_path / "midas" / "val" / "im0_midas.png"), np.int32)
    assert np.abs((255 - a) - b).max() <= 1


def test_bucket_size_matches_the_jax_script():
    """The size buckets (aspect kept, long side <= 512, multiples of 32)."""
    for ow in range(20, 1400, 37):
        for oh in range(20, 1400, 41):
            scale = min(1.0, 512 / max(ow, oh))
            ref = (max(32, int(round(oh * scale / 32)) * 32),
                   max(32, int(round(ow * scale / 32)) * 32))
            assert tgd.bucket_size(ow, oh) == ref


def test_main_refuses_without_weights(image_dir, tmp_path):
    with pytest.raises(SystemExit, match="--allow_random"):
        tgd.main(_argv(image_dir, tmp_path) + ["--device", "cpu"])


def test_int8_names_its_roadmap_item(image_dir, tmp_path):
    """``--dtype int8`` runs (it used to refuse, naming its ROADMAP item):
    ``main --device cpu --allow_random`` on a small ZoeDepth and a small
    DPT_Large (4 blocks) loads float32, quantizes the backbone (int8 block linears,
    bf16 elsewhere), casts the rest to bf16 and writes seven non-constant
    8-bit PNGs per model. Its depth against JAX's int8 forward is in
    ``tests/test_torch_int8.py``."""
    from depthg_tpu_torch.models.layers import W8A8Linear
    from depthg_tpu_torch.models.midas_dpt import MidasDPTConfig
    from depthg_tpu_torch.models.zoedepth import ZoeConfig
    from depthg_tpu_torch.models.zoedepth.beit import BEiTConfig
    from depthg_tpu_torch.models.zoedepth.dpt import DPTConfig

    torch.set_num_threads(2)
    dpt = dict(features=16, reassemble_channels=(8, 16, 32, 32))
    configs = {"zoe_config": ZoeConfig(
        n_bins=8, bin_embedding_dim=16, n_attractors=(2, 2, 1, 1), img_size=(64, 96),
        beit=BEiTConfig(embed_dim=128, depth=4, num_heads=2, pretrain_window=4, hooks=(0, 1, 2, 3)),
        dpt=DPTConfig(embed_dim=128, **dpt)), "midas_config": MidasDPTConfig(
        embed_dim=128, depth=4, num_heads=2, hooks=(0, 1, 2, 3), img_size=64, **dpt)}
    for model in ("zoedepth", "midas"):
        out = tmp_path / model
        argv = _argv(image_dir, out, model, features=False) + [
            "--device", "cpu", "--allow_random", "--dtype", "int8"]
        args = tgd.get_args_parser().parse_args(argv)
        _, net = tgd.build(args, torch.device("cpu"), **configs)
        backbone = (net.core.core if model == "zoedepth" else net).pretrained.model
        linears = [m for m in backbone.modules() if isinstance(m, W8A8Linear)]
        assert len(linears) == 4 * 4 and not any(
            isinstance(m, torch.nn.Linear) for m in backbone.modules())
        assert all(p.dtype == torch.bfloat16 for p in net.parameters())
        assert tgd.main(argv, **configs) == 7
        pngs = sorted((out / "val").glob(f"*_{model}.png"))
        assert len(pngs) == 7
        for p in pngs:
            a = np.asarray(Image.open(p))
            assert a.dtype == np.uint8 and a.shape in ((64, 96), (96, 64)) and a.max() > a.min()


def test_device_defaults_to_the_card(image_dir, tmp_path):
    """Without ``--device`` the card is asked for: on a host without one
    this raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgd.main(_argv(image_dir, tmp_path) + ["--allow_random"])


def test_main_end_to_end_on_the_cpu(image_dir, tmp_path):
    """``main --device cpu --allow_random`` with a 4-block ZoeDepth and a
    4-block DPT_Large: seven 8-bit PNGs per model that are not constant,
    and finite features."""
    from depthg_tpu_torch.models.midas_dpt import MidasDPTConfig
    from depthg_tpu_torch.models.zoedepth import ZoeConfig
    from depthg_tpu_torch.models.zoedepth.beit import BEiTConfig
    from depthg_tpu_torch.models.zoedepth.dpt import DPTConfig

    torch.set_num_threads(2)
    dpt = dict(features=16, reassemble_channels=(8, 16, 32, 32))
    configs = {"zoe_config": ZoeConfig(
        n_bins=8, bin_embedding_dim=16, n_attractors=(2, 2, 1, 1), img_size=(64, 96),
        beit=BEiTConfig(embed_dim=128, depth=4, num_heads=2, pretrain_window=4, hooks=(0, 1, 2, 3)),
        dpt=DPTConfig(embed_dim=128, **dpt)), "midas_config": MidasDPTConfig(
        embed_dim=128, depth=4, num_heads=2, hooks=(0, 1, 2, 3), img_size=64, **dpt)}
    for model in ("zoedepth", "midas"):
        out = tmp_path / model
        n = tgd.main(_argv(image_dir, out, model) + ["--device", "cpu", "--allow_random",
                                                     "--dtype", "float32"], **configs)
        pngs = sorted((out / "val").glob(f"*_{model}.png"))
        assert n == 7 and len(pngs) == 7
        for p in pngs:
            a = np.asarray(Image.open(p))
            assert a.dtype == np.uint8 and a.shape in ((64, 96), (96, 64)) and a.max() > a.min()
        feats = np.load(out / "val" / "im0_feats.npy")
        assert feats.ndim == 3 and np.isfinite(feats).all()
