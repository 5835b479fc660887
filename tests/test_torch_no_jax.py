"""The PyTorch port runs without JAX: in a fresh interpreter, importing
``depthg_tpu_torch`` (and its fidelity-study module) and running the tiny
eval step on the CPU at the default point, the ``safe`` point and the
streaming exact CRF, then one train step and a validation step, leaves ``jax`` and every module of the JAX package
(``depthg_tpu``) out of ``sys.modules``, also after importing the eval and
train CLIs, both profile modules and the serve, load generator, demo, KNN
and crop modules (and after a served request and a KNN on the CPU), and
after the depth slice (``generate_depth``, ZoeDepth, MiDaS, their
converters, ``native_crf`` and the fidelity study's lattice on a tiny
ZoeDepth forward with the attention bias, and ``python -m
depthg_tpu_torch.generate_depth --help``), and after the fine-tune slice
(``finetune_zoedepth``, the losses and one ``finetune_step`` on a tiny
ZoeDepth, the depth metrics, data and reader copies, ``nyuv2_prep`` and a
tiny ZoeDepth-NK forward), and after the variants slice (the trainer's
config with ``arch=dino_depth`` and ``arch=feature-pyramid`` through
``fcfg_from_run_cfg`` and ``load_backbone``, an LHP-"attn" train step and
a validation step on each, ``pooled_features`` of a ResNet-50 and the KNN
CLI with ``model_type=resnet50``), and after the parallel slice
(``parallel.dist`` outside a process group and in a gloo group of one,
``parallel.mesh``'s CPU devices and replicas, and the orbax / ``.npz``
reader of ``utils.checkpoint_io``), and after the int8 slice (an eval step,
a train step and a validation step with ``backbone_dtype="int8"``, a tiny
ZoeDepth and DPT_Large through ``generate_depth.to_dtype(..., "int8")``,
the CRF playground ``train_crf``, ``potsdam_ops``,
``load_pretrained_model_cfg`` and ``backbone_dtype_study``), and after
importing the bench and ``utils.profiling`` (and in two of the bench's
child phases); no source
of the port or of
``chip_smoke.py`` imports either, or reads a file of ``scripts/`` or
``depthg_tpu/``. The attention and bilateral wrappers raise on an input
their kernels cannot take instead of falling back to their plain versions."""

import os
import re
import subprocess
import sys

import pytest
import torch

from depthg_tpu_torch.ops import attention as tatt
from depthg_tpu_torch.ops import crf_bilateral as tbil

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = r"""
import dataclasses
import sys
import torch
import depthg_tpu_torch
import depthg_tpu_torch.eval_segmentation
import depthg_tpu_torch.profile_eval
import depthg_tpu_torch.profile_train
import depthg_tpu_torch.train_segmentation
import depthg_tpu_torch.crop_datasets
import depthg_tpu_torch.demo_segmentation
import depthg_tpu_torch.precompute_knns
import depthg_tpu_torch.serve
import depthg_tpu_torch.serve_loadgen
import depthg_tpu_torch.bench
import depthg_tpu_torch.utils.profiling
from depthg_tpu_torch import crf_fidelity_study, inference
from depthg_tpu_torch.models import featurizer, vit
from depthg_tpu_torch.ops.crf import crf_config_from_cfg

torch.set_num_threads(1)
dev = depthg_tpu_torch.get_device("cpu")
fcfg = featurizer.FeaturizerConfig(
    vit_config=vit.ViTConfig(embed_dim=128, depth=2, num_heads=2), dim=16)
gen = torch.Generator().manual_seed(0)
model = inference.Segmenter(fcfg, 5, 7).init_weights(gen).to(dev)
img = torch.randn(2, 3, 64, 64, generator=gen)
label = torch.randint(-1, 5, (2, 64, 64), generator=gen)
counted = int(((label >= 0) & (label < 5)).sum())
for crf in (crf_config_from_cfg({}),
            crf_config_from_cfg({"crf_downsample": 4, "crf_splat_phases": 0}),
            dataclasses.replace(crf_config_from_cfg({"crf_downsample": 1}),
                                kernel_cache_mb=0)):
    ecfg = inference.EvalConfig(n_classes=5, extra_clusters=2, label_res=64,
                                crf=crf, backbone_dtype="bfloat16")
    lin, clu = inference.make_eval_step(ecfg)(model, img, label)
    assert lin.shape == (5, 5) and clu.shape == (7, 5)
    assert int(lin.sum()) <= counted and int(clu.sum()) <= counted
from depthg_tpu_torch.train import decay, losses, step
hp = step.TrainHParams(n_classes=5, backbone_dtype="bfloat16")
state = step.init_state(fcfg, hp, torch.Generator().manual_seed(1), device=dev)
batch = {"img": img, "img_pos": img.flip(-1), "label": label,
         "depth": torch.rand(2, 1, 64, 64, generator=gen),
         "depth_pos": torch.rand(2, 1, 64, 64, generator=gen)}
logs = step.train_step(state, batch, hp, losses.CorrLossConfig(feature_samples=3, neg_samples=2),
                       0.19, 0.03, generator=gen)
assert state.step == 1 and all(bool(torch.isfinite(v).all()) for v in logs.values())
lin, clu = inference.make_validation_step(5, 0)(state.model, img, label, 64)
assert lin.shape == (5, 5) and clu.shape == (5, 5)
assert decay.sampling_schedule(decay.DecayConfig(), 3) == ("fps", 11)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
theirs = sorted(m for m in sys.modules if m == "depthg_tpu" or m.startswith("depthg_tpu."))
assert not theirs, theirs
cfg = depthg_tpu_torch.eval_segmentation.eval_config(["operating_point=safe", "lr=5e-4"])
assert cfg.lr == 5e-4 and cfg.crf_downsample == 4 and cfg.res == 320
from depthg_tpu_torch.parallel import knn
feats = torch.nn.functional.normalize(torch.randn(50, 8, generator=gen), dim=1)
nns = knn.topk_neighbors(feats, k=5, device="cpu")
assert nns.shape == (50, 5) and nns.dtype.name == "int32" and (nns[:, 0] == range(50)).all()
assert knn.pooled_features(model.net, img).shape == (2, 128)
svc = depthg_tpu_torch.serve.SegmentationService(
    model, inference.EvalConfig(n_classes=5, extra_clusters=2, label_res=64), res=64,
    max_batch=2, max_wait_ms=1.0, device="cpu")
lin, clu = svc.batcher.submit(img[0].numpy())
svc.close()
assert lin.shape == (64, 64) and clu.shape == (64, 64)
import depthg_tpu_torch.generate_depth
from depthg_tpu_torch import native_crf
from depthg_tpu_torch.models import midas_dpt
from depthg_tpu_torch.models.zoedepth import ZoeConfig, ZoeDepth, convert, zoedepth_infer
from depthg_tpu_torch.models.zoedepth.beit import BEiTConfig
from depthg_tpu_torch.models.zoedepth.dpt import DPTConfig
zcfg = ZoeConfig(n_bins=4, bin_embedding_dim=8, n_attractors=(2, 1, 1, 1), img_size=(32, 64),
                 beit=BEiTConfig(embed_dim=128, depth=4, num_heads=2, pretrain_window=2,
                                 hooks=(0, 1, 2, 3), attn_impl="fused"),
                 dpt=DPTConfig(embed_dim=128, features=16, reassemble_channels=(8, 8, 16, 16)))
zoe = ZoeDepth(zcfg).init_weights(torch.Generator().manual_seed(2)).eval()
with torch.no_grad():
    depth = zoedepth_infer(zoe, torch.rand(1, 3, 32, 64, generator=gen))
assert depth.shape == (1, 1, 32, 64) and bool(torch.isfinite(depth).all())
import depthg_tpu_torch.finetune_zoedepth
from depthg_tpu_torch.data import nyuv2_prep
from depthg_tpu_torch.models.zoedepth import config as zconfig, data_mono, eval_datasets, finetune, metrics, nk
tiny = depthg_tpu_torch.finetune_zoedepth.tiny_config()
state = finetune.init_state(ZoeDepth(tiny).init_weights(torch.Generator().manual_seed(3)),
                            finetune.FinetuneConfig(total_steps=4))
logs = finetune.finetune_step(state, {"image": torch.rand(2, 3, 64, 96, generator=gen),
                                      "depth": torch.rand(2, 1, 64, 96, generator=gen) + 0.5,
                                      "mask": torch.ones(2, 1, 64, 96, dtype=torch.bool)})
assert state.step == 1 and bool(torch.isfinite(logs["loss/total"]))
assert metrics.compute_metrics(torch.rand(48, 64).numpy() + 1, torch.rand(24, 32).numpy() + 1,
                               eigen_crop=False)["a1"] > 0
nk_cfg = dataclasses.replace(zconfig.get_config("zoedepth_nk"), bin_embedding_dim=16,
                             router_dim=16, router_heads=2, router_layers=1,
                             beit=zcfg.beit, dpt=dataclasses.replace(zcfg.dpt, features=32))
with torch.no_grad():
    out = nk.ZoeDepthNK(nk_cfg).init_weights(torch.Generator().manual_seed(4))(
        torch.rand(1, 3, 32, 64, generator=gen))
assert out["metric_depth"].shape == (1, 1, 32, 64) and out["domain_logits"].shape == (1, 2)
scene = crf_fidelity_study.make_scene(64, 27, seed=0)
assert crf_fidelity_study.lattice_labels([scene], 64)[0].shape == (64, 64)
import tempfile
from depthg_tpu_torch.config import load_config
from depthg_tpu_torch.models import featurizer_depth, lhp, pyramid
for flags, cls in ((["arch=dino_depth", "guidance=cross_attn"], featurizer_depth.DepthFeaturizerConfig),
                   (["arch=feature-pyramid", "model_type=resnet50", "granularity=2"],
                    pyramid.PyramidConfig)):
    with tempfile.TemporaryDirectory() as out_root:
        run = load_config("local_config.yml", flags + ["dim=8", f"output_root={out_root}"])
        vcfg = depthg_tpu_torch.train_segmentation.fcfg_from_run_cfg(run)
        assert type(vcfg) is cls
        if cls is featurizer_depth.DepthFeaturizerConfig:
            vcfg = dataclasses.replace(vcfg, vit_config=vit.ViTConfig(
                embed_dim=384, depth=1, num_heads=2, img_size=32))
        vhp = step.TrainHParams(n_classes=5, backbone_dtype="bfloat16", lhp=True,
                                lhp_propagation_strategy="attn")
        vstate = step.init_state(vcfg, vhp, torch.Generator().manual_seed(5), device=dev)
        assert depthg_tpu_torch.train_segmentation.load_backbone(run, vstate.model) == "random"
        vlogs = step.train_step(vstate, batch, vhp, losses.CorrLossConfig(feature_samples=3,
                                                                          neg_samples=2),
                                0.19, 0.03, generator=gen)
        assert all(bool(torch.isfinite(v).all()) for v in vlogs.values())
        lin, clu = inference.make_validation_step(5, 0)(vstate.model, img, label, 64)
        assert int(lin.sum()) <= counted
net50, _ = pyramid.backbone_for("resnet50")
assert knn.pooled_features(net50.init_weights(torch.Generator().manual_seed(6)), img).shape == (2, 2048)
with tempfile.TemporaryDirectory() as out_root:  # no weights, no data: a random ResNet, nothing written
    assert depthg_tpu_torch.precompute_knns.main([
        "model_type=resnet50", f"data_dir={out_root}", f"output_root={out_root}", "device=cpu",
        "knn_datasets=[cocostuff27]", "knn_crop_types=[five]", "knn_image_sets=[train]"]) == []
from depthg_tpu_torch import (backbone_dtype_study, generate_depth, load_pretrained_model_cfg,
                              potsdam_ops, train_crf)
from depthg_tpu_torch.models.layers import W8A8Linear
ecfg = inference.EvalConfig(n_classes=5, extra_clusters=2, label_res=64, backbone_dtype="int8")
lin, clu = inference.make_eval_step(ecfg)(model, img, label)
assert int(lin.sum()) <= counted and clu.shape == (7, 5)
hp8 = step.TrainHParams(n_classes=5, backbone_dtype="int8")
state8 = step.init_state(fcfg, hp8, torch.Generator().manual_seed(7), device=dev)
logs = step.train_step(state8, batch, hp8, losses.CorrLossConfig(feature_samples=3, neg_samples=2),
                       0.19, 0.03, generator=gen)
assert all(bool(torch.isfinite(v).all()) for v in logs.values())
zoe8 = generate_depth.to_dtype(ZoeDepth(zcfg).init_weights(torch.Generator().manual_seed(2)), "int8")
with torch.no_grad():
    depth = zoedepth_infer(zoe8.eval(), torch.rand(1, 3, 32, 64, generator=gen).bfloat16())
assert bool(torch.isfinite(depth.float()).all())
mcfg = midas_dpt.MidasDPTConfig(embed_dim=128, depth=4, num_heads=2, hooks=(0, 1, 2, 3),
                                img_size=64, features=16, reassemble_channels=(8, 8, 16, 16))
dpt8 = generate_depth.to_dtype(midas_dpt.MidasDPT(mcfg).init_weights(
    torch.Generator().manual_seed(8)), "int8")
assert sum(isinstance(m, W8A8Linear) for m in dpt8.modules()) == 16
cfg_crf = load_config("local_config.yml", ["crf_samples=20", "dim=4"])
table = torch.randn(2, 4, 8, 8, generator=gen, requires_grad=True)
train_crf.objective(table, torch.randn(2, 3, 8, 8, generator=gen), cfg_crf,
                    generator=gen)[0].backward()
assert table.grad is not None and callable(potsdam_ops.convert_mat)
assert callable(load_pretrained_model_cfg.main) and callable(backbone_dtype_study.run_one)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
theirs = sorted(m for m in sys.modules if m == "depthg_tpu" or m.startswith("depthg_tpu."))
assert not theirs, theirs
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", PROGRAM], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


PARALLEL_PROGRAM = r"""
import socket, sys, tempfile, os
import numpy as np
import torch
from depthg_tpu_torch.parallel import dist, mesh
from depthg_tpu_torch.utils import checkpoint_io
x = torch.arange(6.0).reshape(3, 2)
assert not dist.active() and dist.world() == 1 and dist.rank() == 0 and dist.is_main()
assert dist.all_gather(x) is x and dist.all_reduce_sum(x) is x and dist.mean(x) is x
assert dist.shard_rows(x) is x[0:3] or torch.equal(dist.shard_rows(x), x)
assert dist.check_world(None) == 1 and dist.rank_device("cpu").type == "cpu"
assert mesh.make_devices(2, "cpu") == [torch.device("cpu")] * 2
reps = mesh.replicate(torch.nn.Linear(2, 2), mesh.make_devices(2, "cpu"))
assert reps[0] is not reps[1] and torch.equal(reps[0].weight, reps[1].weight)
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                     rank=0, world_size=1)
assert dist.active() and dist.world() == 1
assert torch.equal(dist.all_reduce_sum(x), x) and torch.equal(dist.mean(x), x)
assert torch.equal(dist.all_gather(x), x)
y = x.clone().requires_grad_(True)
dist.sum_with_grad(y).sum().backward()
assert torch.equal(y.grad, torch.ones_like(x))
dist.average_gradients([y])
assert torch.equal(y.grad, torch.ones_like(x))
g = torch.Generator().manual_seed(0)
assert dist.draw_rows(lambda n: torch.rand((n, 2), generator=g), 3).shape == (3, 2)
batch = dist.pad_batch({"img": np.zeros((3, 1)), "label": np.zeros((3, 1), np.int64)})
assert len(batch["img"]) == 3
torch.distributed.destroy_process_group()
with tempfile.TemporaryDirectory() as d:
    np.savez(os.path.join(d, "t.npz"), **{"a.0.w": np.ones(2), "a.1.w": np.zeros(2), "b": np.eye(2)})
    tree = checkpoint_io.read_npz(os.path.join(d, "t.npz"))
    assert isinstance(tree["a"], list) and tree["a"][0]["w"].sum() == 2 and tree["b"].shape == (2, 2)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "depthg_tpu."))
             or m == "depthg_tpu")
assert not bad, bad
print("PARALLEL_OK")
"""


def test_parallel_and_checkpoint_reader_run_without_jax():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", PARALLEL_PROGRAM], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PARALLEL_OK" in proc.stdout


def test_bench_children_run_without_jax():
    """Two of the bench's child phases (the eval ``safe`` point and the IO
    phase at smoke size on the CPU), run as ``python -m
    depthg_tpu_torch.bench`` runs them, leave JAX and the JAX package out of
    ``sys.modules``."""
    program = (
        "import json, runpy, sys, io, contextlib\n"
        "for args in (['--phase', 'eval', '--point', 'safe'], ['--phase', 'io']):\n"
        "    sys.argv = ['bench', *args, '--device', 'cpu']\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        runpy.run_module('depthg_tpu_torch.bench', run_name='__main__')\n"
        "    assert json.loads(buf.getvalue().splitlines()[-1]), args\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'depthg_tpu.'))"
        " or m == 'depthg_tpu')\n"
        "assert not bad, bad\n"
        "print('BENCH_OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"PYTHONPATH": ROOT, "BENCH_SMOKE": "1", "OMP_NUM_THREADS": "2"})
    env.pop("BENCH_FAULT_INJECT", None)
    proc = subprocess.run([sys.executable, "-c", program], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BENCH_OK" in proc.stdout


def test_depth_cli_help_runs_without_jax():
    program = (
        "import runpy, sys\n"
        "sys.argv = ['generate_depth', '--help']\n"
        "try:\n"
        "    runpy.run_module('depthg_tpu_torch.generate_depth', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'depthg_tpu.'))"
        " or m == 'depthg_tpu')\n"
        "assert not bad, bad\n"
        "print('HELP_OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", program], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "--allow_random" in proc.stdout and "HELP_OK" in proc.stdout


# a path into the JAX side: a module loaded by file, or a join or a Path
# component naming scripts/ or depthg_tpu/
FOREIGN_PATH = re.compile(
    r"spec_from_file_location|join\([^)]*[\"'](scripts|depthg_tpu)[\"']|/\s*[\"'](scripts|depthg_tpu)[\"']")


def test_no_port_source_reads_the_jax_side():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "depthg_tpu_torch")):
        paths += [os.path.join(dirpath, name) for name in files if name.endswith(".py")]
    for path in paths:
        with open(path) as f:
            found = FOREIGN_PATH.search(f.read())
        assert found is None, (path, found.group(0))
    for line in ('os.path.join(ROOT, "scripts", "x.py")', "Path(ROOT) / 'depthg_tpu'",
                 "importlib.util.spec_from_file_location(name, path)"):
        assert FOREIGN_PATH.search(line), line
    assert not FOREIGN_PATH.search('os.path.join(ROOT, "native", "crf")')


# an import of jax or of the JAX package (never of depthg_tpu_torch)
FOREIGN_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|depthg_tpu)(\s|\.|$)|import_module\([\"'](jax|depthg_tpu)[\"'.]",
    re.MULTILINE)


def test_no_jax_import_in_package_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "depthg_tpu_torch")):
        paths += [os.path.join(dirpath, name) for name in files if name.endswith(".py")]
    assert len(paths) > 20
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert "import jax" not in src and "from jax" not in src, path
        found = FOREIGN_IMPORT.search(src)
        assert found is None, (path, found.group(0))
    for line in ("import depthg_tpu", "from depthg_tpu.config import Config",
                 "    from depthg_tpu import data", "import jax.numpy as jnp"):
        assert FOREIGN_IMPORT.search(line), line
    for line in ("import depthg_tpu_torch", "from depthg_tpu_torch.config import Config",
                 "# see depthg_tpu/config.py", "from depthg_tpu_torch import data"):
        assert not FOREIGN_IMPORT.search(line), line


def test_kernel_path_raises_instead_of_falling_back():
    """The kernel launcher refuses a CPU tensor (it never runs the plain
    version), and the public wrapper refuses what the kernel cannot take."""
    qkv = torch.zeros(1, 64, 3 * 128)
    q, k, v = tatt.split_qkv(qkv, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tatt._launch(q, k, v, torch.empty_like(q), 0.125, 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tatt.attention_qkv(qkv.double(), 2, 0.125)
    feats, values = torch.zeros(2, 64, 5), torch.zeros(2, 64, 27)
    with pytest.raises(ValueError, match="CUDA"):
        tbil._launch(feats, values, torch.empty_like(values))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tbil.bilateral_message(feats, values.double())
