"""The offline pipeline of the port on the synthetic COCO of
``tests/test_e2e_pipeline.py``: (a) the port's and the JAX package's
``crop_datasets.main`` write the same files, byte for byte; (b) both
``precompute_knns.main`` from one DINO-style ``.pth`` (and from one
ResNet-50 file) with ``matmul_precision=highest`` write the same file name
and the same ``nns`` array (int32 [40, 30]; indices equal except where two
similarities lie within 1e-5); (c) crop -> knn -> train 3 steps -> eval -> demo -> one served
request, all through the port's mains with ``device=cpu`` in a fresh
interpreter that never imports ``jax`` or ``depthg_tpu``."""

import filecmp
import importlib.util
import os
import subprocess
import sys
from os.path import join

import numpy as np
import pytest
import torch
from PIL import Image

from depthg_tpu_torch import crop_datasets as tcrop
from depthg_tpu_torch import precompute_knns as tknns
from depthg_tpu_torch.models import vit as tvit

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = join(ROOT, "scripts")

COMMON = [
    "model_type=vit_tiny", "dim=16", "res=32", "batch_size=4", "num_workers=2",
    "feature_samples=3", "neg_samples=2", "num_neighbors=3",
]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"depthg_scripts_{name}", join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_coco(root):
    """The fixture of ``tests/test_e2e_pipeline.py``: 8 train and 4 val
    images of 96 x 96 with labels and depth in the Coco layout."""
    rng = np.random.default_rng(0)
    base = join(root, "cocostuff")
    ids = {"train2017": [f"img{i}" for i in range(8)],
           "val2017": [f"val{i}" for i in range(4)]}
    for split, names in ids.items():
        for sub in ("curated", "images", "annotations", "depth"):
            os.makedirs(join(base, sub, split), exist_ok=True)
        for lst in ("Coco164kFull_Stuff_Coarse.txt", "Coco164kFull_Stuff_Coarse_7.txt"):
            with open(join(base, "curated", split, lst), "w") as f:
                f.write("\n".join(names))
        for n in names:
            Image.fromarray(rng.integers(0, 255, (96, 96, 3), np.uint8)).save(
                join(base, "images", split, n + ".jpg"))
            Image.fromarray(rng.integers(0, 182, (96, 96)).astype(np.uint8)).save(
                join(base, "annotations", split, n + ".png"))
            Image.fromarray(rng.integers(0, 255, (96, 96), np.uint8)).save(
                join(base, "depth", split, n + "_zoedepth.png"))
    return root


def _tree(root):
    out = []
    for dirpath, _, files in os.walk(root):
        out += [os.path.relpath(join(dirpath, f), root) for f in files]
    return sorted(out)


@pytest.fixture(scope="module")
def cropped(tmp_path_factory):
    """Two copies of the synthetic COCO, cropped by the JAX package's script
    and by the port's module with the same arguments."""
    roots = {}
    for who, main in (("jax", _load_script("crop_datasets").main), ("torch", tcrop.main)):
        root = make_coco(str(tmp_path_factory.mktemp(f"coco_{who}")))
        main(COMMON + [f"data_dir={root}", "crop_datasets=[cocostuff27]",
                       "crop_image_sets=[train]", "generate_depth=True"])
        roots[who] = root
    return roots


def test_crop_datasets_writes_the_jax_packages_files(cropped):
    ref, out = (join(cropped[w], "cropped") for w in ("jax", "torch"))
    files = _tree(ref)
    assert _tree(out) == files and len(files) == 120  # 40 crops x img, label, depth
    assert files[0].startswith("cocostuff27_five_crop_0.5" + os.sep)
    _, mismatch, errors = filecmp.cmpfiles(ref, out, files, shallow=False)
    assert not mismatch and not errors
    lab = np.asarray(Image.open(join(out, "cocostuff27_five_crop_0.5", "label", "train", "0.png")))
    assert lab.shape == (48, 48) and lab.min() >= 0  # stored +1


@pytest.mark.parametrize("crop_type,seed", [("random", 3), ("five", 0)])
def test_crop_helpers_match_the_jax_packages(crop_type, seed):
    jcrop = _load_script("crop_datasets")
    arr = np.random.default_rng(seed).random((3, 37, 52)).astype(np.float32)
    if crop_type == "five":
        ref, out = jcrop.five_crop_np(arr, 18, 26), tcrop.five_crop_np(arr, 18, 26)
    else:
        ref, out = jcrop.random_crops_np(arr, 18, 26, seed), tcrop.random_crops_np(arr, 18, 26, seed)
    assert len(out) == len(ref) == 5
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
        np.testing.assert_array_equal(tcrop.to_uint8_img(o), jcrop.to_uint8_img(r))


def test_precompute_knns_writes_the_jax_packages_file(cropped, tmp_path):
    """One DINO-style ``.pth`` (teacher wrapper, ``module.backbone.``
    prefixes, a head key to drop) through both mains."""
    vit = tvit.VisionTransformer(tvit.make_config("vit_tiny", 8)).init_weights(
        torch.Generator().manual_seed(7))
    pth = str(tmp_path / "dino.pth")
    torch.save({"teacher": {**{"module.backbone." + k: v for k, v in vit.state_dict().items()},
                            "module.head.last_layer.weight": torch.zeros(3, 3)}}, pth)
    args = COMMON + ["knn_datasets=[cocostuff27]", "knn_crop_types=[five]",
                     "knn_image_sets=[train]", "matmul_precision=highest",
                     f"pretrained_weights={pth}"]
    name = "nns_vit_tiny_cocostuff27_train_five_32.npz"
    _load_script("precompute_knns").main(args + [f"data_dir={cropped['jax']}"])
    written = tknns.main(args + [f"data_dir={cropped['torch']}", "device=cpu"])
    assert written == [join(cropped["torch"], "nns", name)]
    assert os.listdir(join(cropped["jax"], "nns")) == [name]
    ref = np.load(join(cropped["jax"], "nns", name))["nns"]
    out = np.load(written[0])["nns"]
    assert out.dtype == ref.dtype == np.int32 and out.shape == ref.shape == (40, 30)
    assert (out[:, 0] == np.arange(40)).all()
    # a second run finds the file and computes nothing
    assert tknns.main(args + [f"data_dir={cropped['torch']}", "device=cpu"]) == []

    rows, cols = np.nonzero(out != ref)
    if len(rows):  # a near-tie may order either way: hold it to the similarities
        from depthg_tpu_torch.config import load_config
        from depthg_tpu_torch.data import ContrastiveSegDataset, get_transform
        from depthg_tpu_torch.inference import fcfg_from_run_cfg
        from depthg_tpu_torch.models.featurizer import DinoFeaturizer

        cfg = load_config("local_config.yml", args + [f"data_dir={cropped['torch']}"])
        net = DinoFeaturizer(fcfg_from_run_cfg(cfg))
        net.model.load_state_dict(vit.state_dict())
        dataset = ContrastiveSegDataset(
            data_dir=cfg.data_dir, dataset_name="cocostuff27", crop_type="five",
            image_set="train", transform=get_transform(32, False, "center"),
            target_transform=get_transform(32, True, "center"), cfg=cfg)
        feats = tknns.embed_dataset(dataset, net.eval(), 64, 1, "highest", "cpu").astype(np.float64)
        for r, c in zip(rows, cols):
            assert abs(feats[r] @ feats[out[r, c]] - feats[r] @ feats[ref[r, c]]) <= 1e-5, (r, c)
    print("nns entries that differ (near-ties):", len(rows), "of", out.size)


def test_precompute_knns_refuses_what_is_not_ported(cropped, tmp_path):
    """More than one device raises; the CNN backbones are ported:
    ``model_type=resnet50`` reads ``{output_root}/data`` and writes the JAX
    script's ``nns`` array from the same file (pooled over H and W;
    indices equal except where two similarities lie within 1e-5), and
    ``vgg11`` without its file embeds with a random backbone."""
    import shutil

    from depthg_tpu_torch.models.pyramid import ResNet50

    data = {who: str(tmp_path / who) for who in cropped}
    for who, root in cropped.items():
        shutil.copytree(join(root, "cropped"), join(data[who], "cropped"))
    os.makedirs(tmp_path / "data")
    resnet = ResNet50().init_weights(torch.Generator().manual_seed(2))
    torch.save(resnet.state_dict(), tmp_path / "data" / "resnet50-0676ba61.pth")
    knn = COMMON + ["knn_datasets=[cocostuff27]", "knn_crop_types=[five]",
                    "knn_image_sets=[train]", "matmul_precision=highest",
                    f"output_root={tmp_path}", "model_type=resnet50"]
    _load_script("precompute_knns").main(knn + [f"data_dir={data['jax']}"])
    written = tknns.main(knn + [f"data_dir={data['torch']}", "device=cpu"])
    name = "nns_resnet50_cocostuff27_train_five_32.npz"
    assert written == [join(data["torch"], "nns", name)]
    ref = np.load(join(data["jax"], "nns", name))["nns"]
    out = np.load(written[0])["nns"]
    assert out.shape == ref.shape == (40, 30) and (out[:, 0] == np.arange(40)).all()
    rows, cols = np.nonzero(out != ref)
    if len(rows):  # a near-tie may order either way: hold it to the similarities
        from depthg_tpu_torch.config import load_config
        from depthg_tpu_torch.data import ContrastiveSegDataset, get_transform

        cfg = load_config("local_config.yml", knn + [f"data_dir={data['torch']}"])
        dataset = ContrastiveSegDataset(
            data_dir=cfg.data_dir, dataset_name="cocostuff27", crop_type="five",
            image_set="train", transform=get_transform(32, False, "center"),
            target_transform=get_transform(32, True, "center"), cfg=cfg)
        feats = tknns.embed_dataset(dataset, resnet.eval(), 64, 1, None, "cpu")
        feats = feats.astype(np.float64)
        for r, c in zip(rows, cols):
            assert abs(feats[r] @ feats[out[r, c]] - feats[r] @ feats[ref[r, c]]) <= 1e-5, (r, c)
    vgg = tknns.main(knn[:-1] + ["model_type=vgg11", f"data_dir={data['torch']}", "device=cpu"])
    assert (np.load(vgg[0])["nns"][:, 0] == np.arange(40)).all()

    args = COMMON + [f"data_dir={tmp_path}", "device=cpu"]
    with pytest.raises(ValueError, match="No model: resnet18"):
        tknns.main(args + ["model_type=resnet18"])
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 4"):
        tknns.main(args + ["n_devices=4"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            tknns.main(COMMON + [f"data_dir={tmp_path}"])
    # data that is absent is skipped, as in the JAX script
    assert tknns.main(args + ["knn_datasets=[cocostuff27]", "knn_crop_types=[five]",
                              "knn_image_sets=[train]"]) == []


PROGRAM = r"""
import io, json, os, sys, urllib.request
from os.path import join
import numpy as np
import torch
torch.set_num_threads(1)
from PIL import Image
from depthg_tpu_torch import (crop_datasets, demo_segmentation, eval_segmentation,
                              precompute_knns, serve, serve_loadgen, train_segmentation)
from depthg_tpu_torch.config import load_config

root, out_root = sys.argv[1], sys.argv[2]
args = %r + [f"data_dir={root}", f"output_root={out_root}", "device=cpu"]

crop_datasets.main(args + ["crop_datasets=[cocostuff27]", "crop_image_sets=[train]",
                           "generate_depth=True"])
crop_dir = join(root, "cropped", "cocostuff27_five_crop_0.5")
assert len(os.listdir(join(crop_dir, "img", "train"))) == 40
assert len(os.listdir(join(crop_dir, "depth", "train"))) == 40

precompute_knns.main(args + ["knn_datasets=[cocostuff27]", "knn_crop_types=[five]",
                             "knn_image_sets=[train]"])
nns = np.load(join(root, "nns", "nns_vit_tiny_cocostuff27_train_five_32.npz"))["nns"]
assert nns.shape == (40, 30) and nns.dtype == np.int32
assert (nns[:, 0] == np.arange(40)).all()

res = train_segmentation.main(args + [
    "max_steps=3", "val_freq=3", "scalar_log_freq=1", "use_depth=True",
    "depth_sampling=fps", "depth_feat_correlation_loss=True", "experiment_name=e2e",
    "wandb_logging=False", "tensorboard_logging=False"])
assert res["step"] == 3 and all(np.isfinite(v) for v in res["last_logs"].values())
ckpt = join(res["checkpoint_dir"], "last.ckpt")

metrics = eval_segmentation.main(args + [
    f"model_paths=[{ckpt}]", "run_crf=True", "crf_downsample=2", "run_prediction=False",
    "experiment_name=e2e_eval"])
vals = metrics[ckpt]
assert np.isfinite(vals["final/cluster/mIoU"]) and vals["n_images"] == 4
assert json.load(open(join(out_root, "eval_metrics.json")))[ckpt]["n_images"] == 4

image_dir = join(root, "cocostuff", "images", "val2017")
result_dir = demo_segmentation.main([
    f"model_path={ckpt}", f"image_dir={image_dir}", f"output_root={out_root}", "res=32",
    "batch_size=1", "experiment_name=e2e_demo", "device=cpu"])
for probe in ("linear", "cluster"):
    names = sorted(os.listdir(join(result_dir, probe)))
    assert names == [f"val{i}.png" for i in range(4)], names
    png = np.asarray(Image.open(join(result_dir, probe, names[0])))
    assert png.shape == (32, 32) and png.dtype == np.uint8 and png.max() < 27

cfg = load_config("serve_config.yml", [f"model_path={ckpt}", "res=32", "max_batch=2",
                                       "max_wait_ms=5", "crf_downsample=2"])
svc = serve.build_service(cfg, "cpu")
assert svc.warmup() == [1, 2]
server = serve.serve_http(svc, port=0)
try:
    base = f"http://127.0.0.1:{server.server_address[1]}"
    with open(join(image_dir, "val0.jpg"), "rb") as f:
        body = f.read()
    req = urllib.request.Request(f"{base}/v1/segment?format=npz", data=body, method="POST")
    blob = np.load(io.BytesIO(urllib.request.urlopen(req, timeout=120).read()))
    assert blob["cluster"].shape == (32, 32) and blob["linear"].dtype == np.int32
    # the demo wrote the same image's labels through the same predict step
    demo = np.asarray(Image.open(join(result_dir, "cluster", "val0.png")))
    assert (demo == blob["cluster"]).mean() >= 0.995
    load = serve_loadgen.run(base, body, clients=2, seconds=0.5)
    assert load["errors"] == 0 and load["completed"] >= 1
finally:
    server.shutdown()
    svc.close()

assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
theirs = sorted(m for m in sys.modules if m == "depthg_tpu" or m.startswith("depthg_tpu."))
assert not theirs, theirs
print("PIPELINE_OK")
""" % (COMMON,)


def test_pipeline_runs_in_the_port_alone(tmp_path):
    root = make_coco(str(tmp_path / "data"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", PROGRAM, root, str(tmp_path / "out")],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    assert "PIPELINE_OK" in proc.stdout
