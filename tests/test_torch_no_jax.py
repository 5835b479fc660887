"""The PyTorch port runs without JAX: in a fresh interpreter, importing
``depthg_tpu_torch`` (and its fidelity-study module) and running the tiny
eval step on the CPU at the default point, the ``safe`` point and the
streaming exact CRF leaves ``jax`` and every module of the JAX package
(``depthg_tpu``) out of ``sys.modules``, also after importing the eval CLI;
no source of the port or of ``chip_smoke.py`` imports either. The attention
and bilateral wrappers raise on an input their kernels cannot take instead
of falling back to their plain versions."""

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
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
theirs = sorted(m for m in sys.modules if m == "depthg_tpu" or m.startswith("depthg_tpu."))
assert not theirs, theirs
cfg = depthg_tpu_torch.eval_segmentation.eval_config(["operating_point=safe", "lr=5e-4"])
assert cfg.lr == 5e-4 and cfg.crf_downsample == 4 and cfg.res == 320
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", PROGRAM], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


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
