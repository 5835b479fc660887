"""The port's trainer CLI on the CPU at a tiny size, on
``tests/synthetic_data.py``'s dataset: ``model_type=vit_tiny dim=16 res=32
batch_size=4 device=cpu``. Two steps, a validation, a Lightning ``.ckpt``
that the port's eval loader and the JAX package's loader read back to the
same weights, and ``resume=`` continuing at the saved step with the loss an
uninterrupted run logs at that step (both runs are the same float32 ops on
the same host: held to 1e-6 relative).
"""

import json
import os
from os.path import join

import numpy as np
import pytest
import torch
from PIL import Image

from depthg_tpu.utils import ckpt as jckpt
from depthg_tpu_torch import train_segmentation
from depthg_tpu_torch.config import load_config
from depthg_tpu_torch.inference import Segmenter, fcfg_from_run_cfg
from depthg_tpu_torch.utils import ckpt as tckpt
from synthetic_data import make_cropped_dataset, make_nns

torch.set_num_threads(1)


def _dataset(root):
    make_cropped_dataset(root, n=8, size=64, splits=("train",))
    make_nns(root, "vit_tiny", "cocostuff27", "train", "five", 32, n=8)
    base = join(root, "cocostuff")  # a minimal val split in the Coco layout
    for sub in ("curated/val2017", "images/val2017", "annotations/val2017"):
        os.makedirs(join(base, sub), exist_ok=True)
    rng = np.random.default_rng(0)
    with open(join(base, "curated/val2017/Coco164kFull_Stuff_Coarse_7.txt"), "w") as f:
        f.write("v0\nv1")
    for n in ("v0", "v1"):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(
            join(base, "images/val2017", n + ".jpg"))
        Image.fromarray(rng.integers(0, 182, (64, 64)).astype(np.uint8)).save(
            join(base, "annotations/val2017", n + ".png"))


def _args(root, out, **kw):
    args = {"model_type": "vit_tiny", "dim": 16, "res": 32, "batch_size": 4,
            "num_workers": 1, "feature_samples": 3, "neg_samples": 2, "num_neighbors": 3,
            "data_dir": root, "output_root": out, "val_freq": 100, "scalar_log_freq": 1,
            "experiment_name": "cli", "device": "cpu", "tensorboard_logging": False,
            "depth_feat_weight": 0.19, "depth_feat_shift": 0.03}
    args.update(kw)
    return [f"{k}={v}" for k, v in args.items()]


@pytest.fixture(scope="module")
def two_steps(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    _dataset(root)
    out = str(tmp_path_factory.mktemp("out2"))
    return root, train_segmentation.main(_args(root, out, max_steps=2, val_freq=2))


def test_cli_trains_validates_and_checkpoints(two_steps):
    _, res = two_steps
    assert res["step"] == 2
    assert all(np.isfinite(v) for v in res["last_logs"].values())
    assert {"loss/total", "loss/linear", "loss/cluster", "loss/pos_intra",
            "loss/depth_feat"} <= set(res["last_logs"])
    for key in ("test/cluster/mIoU", "test/linear/Accuracy", "test/Maxcluster/mIoU"):
        assert np.isfinite(res["metrics"][key]), key
    with open(res["log_path"]) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "test/cluster/mIoU" in r] == [2, 2]
    files = sorted(os.listdir(res["checkpoint_dir"]))
    assert files == sorted(f"{tag}{ext}" for tag in ("best", "last", "step2")
                           for ext in (".pt", ".ckpt", ".train_state.pt"))


def test_ckpt_loads_in_both_packages_to_the_same_weights(two_steps):
    _, res = two_steps
    path = join(res["checkpoint_dir"], "last.ckpt")
    sd, hparams = tckpt.load_lightning_ckpt(path)
    assert hparams["model_type"] == "vit_tiny" and hparams["dim"] == 16
    model = Segmenter.from_state_dict(sd, fcfg_from_run_cfg(load_config(
        "local_config.yml", ["model_type=vit_tiny", "dim=16"])))
    assert model.linear_probe.weight.shape == (27, 16, 1, 1)
    params, jhparams = jckpt.load_lightning_ckpt(path)
    assert jhparams == hparams
    assert "decoder" in params  # the training side's decoder is kept in the file
    back = tckpt.state_dict_from_jax(params)  # the JAX tree, exported again
    assert sorted(back) == sorted(sd)
    for key in sd:
        assert torch.equal(back[key], sd[key]), key
    blob = torch.load(path, map_location="cpu", weights_only=False)
    assert blob["global_step"] == 2 and blob["hyper_parameters"]["n_classes"] == 27
    assert blob["state_dict"]["decoder.weight"].shape == (192, 16, 1, 1)


def test_resume_continues_like_an_uninterrupted_run(two_steps, tmp_path):
    root, res2 = two_steps
    straight = train_segmentation.main(_args(root, str(tmp_path / "a"), max_steps=3))
    resumed = train_segmentation.main(_args(
        root, str(tmp_path / "b"), max_steps=3,
        resume=join(res2["checkpoint_dir"], "last.train_state.pt")))
    assert straight["step"] == resumed["step"] == 3
    for name, ref in straight["last_logs"].items():
        np.testing.assert_allclose(resumed["last_logs"][name], ref, rtol=1e-6, atol=1e-8,
                                   err_msg=name)
    blob = torch.load(join(resumed["checkpoint_dir"], "last.train_state.pt"),
                      map_location="cpu", weights_only=False)
    assert blob["step"] == 3 and sorted(blob["opt"]) == ["cluster", "linear", "net"]
    assert not any(k.startswith("net.model.") for k in blob["model"])
    assert blob["opt"]["net"]["state"][0]["step"] == 3


def test_cli_refuses_what_is_not_ported(two_steps, tmp_path):
    """More than one device without torchrun, an unknown arch, a pickled
    resume and ``arch=feature-pyramid`` with ``rec_weight > 0`` (with the JAX
    trainer's message, before the device, the data or the weights are
    touched: ``device=cuda`` on a host without a card) raise.
    ``arch=dino_depth``, ``lhp=True``, ``arch=feature-pyramid`` and
    ``backbone_dtype=int8`` are ported: each trains a step on the synthetic
    layout, validates and checkpoints (the Lightning ``.ckpt`` for
    ``arch=dino`` only, as the JAX trainer writes it; ``<tag>.pt`` for every
    arch)."""
    root = str(tmp_path)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 4"):
        train_segmentation.main(_args(root, root) + ["n_devices=4"])
    for flags, match in ((["arch=resnet"], "arch=resnet"),
                         (["resume=state.pkl"], "pickled optax state"),
                         (["arch=feature-pyramid", "rec_weight=1.0", "device=cuda"],
                          "rec_weight > 0 is unsupported for arch=feature-pyramid")):
        with pytest.raises(NotImplementedError, match=match):
            train_segmentation.main(_args(root, root) + flags)
    data, _ = two_steps
    for flags, model_type, logged in (
            (["arch=dino_depth", "guidance=cross_attn"], "vit_small", "loss/depth_feat"),
            (["lhp=True", "propagation_strategy=attn"], "vit_tiny", "loss/lhp_pos_intra"),
            (["arch=feature-pyramid", "granularity=2"], "resnet50", "loss/pos_intra"),
            (["backbone_dtype=int8"], "vit_tiny", "loss/pos_intra")):
        make_nns(data, model_type, "cocostuff27", "train", "five", 32, n=8)
        res = train_segmentation.main(_args(data, str(tmp_path / flags[0]), max_steps=1,
                                            model_type=model_type) + flags)
        assert res["step"] == 1 and logged in res["last_logs"], flags
        assert all(np.isfinite(v) for v in res["last_logs"].values()), flags
        assert np.isfinite(res["metrics"]["test/cluster/mIoU"]), flags
        ext = (".pt", ".ckpt", ".train_state.pt") if "arch=" not in flags[0] else (
            ".pt", ".train_state.pt")
        assert sorted(os.listdir(res["checkpoint_dir"])) == sorted(
            "last" + e for e in ext), flags


def test_load_backbone_for_the_pyramid(tmp_path):
    """``arch=feature-pyramid`` reads ``load_model(model_type,
    {output_root}/data)``; a model_type outside the ResNet-50 family raises
    before the filesystem is read; without the file the seed's random
    ResNet-50 stays."""
    from depthg_tpu_torch.models.pyramid import ResNet50

    cfg = load_config("local_config.yml", ["arch=feature-pyramid", "model_type=resnet50",
                                           f"output_root={tmp_path}", "dim=8"])
    model = Segmenter(fcfg_from_run_cfg(cfg), 27, 27).init_weights(torch.Generator().manual_seed(0))
    seeded = {k: v.clone() for k, v in model.net.model.state_dict().items()}
    assert train_segmentation.load_backbone(cfg, model) == "random"
    assert all(torch.equal(v, seeded[k]) for k, v in model.net.model.state_dict().items())
    src = ResNet50().init_weights(torch.Generator().manual_seed(1)).state_dict()
    os.makedirs(tmp_path / "data")
    torch.save(src, tmp_path / "data" / "resnet50-0676ba61.pth")
    assert train_segmentation.load_backbone(cfg, model) == "resnet50"
    assert all(torch.equal(v, src[k]) for k, v in model.net.model.state_dict().items())
    cfg.model_type = "vgg11"
    with pytest.raises(ValueError, match="resnet50-family"):
        train_segmentation.load_backbone(cfg, model)


def test_cli_never_picks_the_cpu_by_itself(tmp_path):
    """The default device is cuda; without a card the CLI raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = [a for a in _args(str(tmp_path), str(tmp_path)) if not a.startswith("device=")]
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train_segmentation.main(args)


def test_load_backbone_reads_a_dino_pth_and_a_lightning_ckpt(tmp_path):
    cfg = load_config("local_config.yml", ["model_type=vit_tiny", "dim=16"])
    fcfg = fcfg_from_run_cfg(cfg)
    src = Segmenter(fcfg, 27, 27, decoder=True).init_weights(torch.Generator().manual_seed(1))
    vit_sd = src.net.model.state_dict()
    pth = str(tmp_path / "dino.pth")
    torch.save({"teacher": {**{"module.backbone." + k: v for k, v in vit_sd.items()},
                            "module.head.last_layer.weight": torch.zeros(3, 3)}}, pth)
    ckpt = str(tmp_path / "seg.ckpt")
    tckpt.export_lightning_ckpt(ckpt, src.state_dict(), cfg=dict(cfg))
    for path in (pth, ckpt):
        model = Segmenter(fcfg, 27, 27, decoder=True).init_weights(torch.Generator().manual_seed(2))
        cfg.pretrained_weights = path
        assert train_segmentation.load_backbone(cfg, model) == path
        for k, v in model.net.model.state_dict().items():
            assert torch.equal(v, vit_sd[k]), k
    cfg.pretrained_weights = str(tmp_path / "missing.pth")
    assert train_segmentation.load_backbone(cfg, model) == "random"


def test_loader_seek_repeats_an_uninterrupted_stream():
    from depthg_tpu_torch.data.loader import DataLoader

    class Items:
        def __len__(self):
            return 10

        def __getitem__(self, i, rng=None):
            return {"i": int(i), "r": float(rng.random())}

    def stream(loader, n):
        out = []
        while len(out) < n:
            for b in loader:
                out.append((b["i"].tolist(), b["r"].tolist()))
                if len(out) == n:
                    break
        return out

    full = stream(DataLoader(Items(), 3, shuffle=True, drop_last=True, seed=4, num_workers=1), 8)
    for skip in (0, 2, 3, 7):
        loader = DataLoader(Items(), 3, shuffle=True, drop_last=True, seed=4, num_workers=1)
        loader.seek(skip)
        assert stream(loader, 8 - skip) == full[skip:]
