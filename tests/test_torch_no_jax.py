"""The PyTorch port runs without JAX: in a fresh interpreter, importing
``depthg_tpu_torch`` and running the tiny eval step on the CPU leaves
``jax`` out of ``sys.modules``. The attention wrapper raises on an input
its kernel cannot take instead of falling back to its plain version."""

import os
import subprocess
import sys

import pytest
import torch

from depthg_tpu_torch.ops import attention as tatt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = r"""
import sys
import torch
import depthg_tpu_torch
from depthg_tpu_torch import inference
from depthg_tpu_torch.models import featurizer, vit
from depthg_tpu_torch.ops.crf import crf_config_from_cfg

torch.set_num_threads(1)
dev = depthg_tpu_torch.get_device("cpu")
fcfg = featurizer.FeaturizerConfig(
    vit_config=vit.ViTConfig(embed_dim=128, depth=2, num_heads=2), dim=16)
gen = torch.Generator().manual_seed(0)
model = inference.Segmenter(fcfg, 5, 7).init_weights(gen).to(dev)
ecfg = inference.EvalConfig(n_classes=5, extra_clusters=2, label_res=64,
                            crf=crf_config_from_cfg({}),
                            backbone_dtype="bfloat16")
img = torch.randn(2, 3, 64, 64, generator=gen)
label = torch.randint(-1, 5, (2, 64, 64), generator=gen)
lin, clu = inference.make_eval_step(ecfg)(model, img, label)
assert lin.shape == (5, 5) and clu.shape == (7, 5)
counted = int(((label >= 0) & (label < 5)).sum())
assert int(lin.sum()) <= counted and int(clu.sum()) <= counted
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", PROGRAM], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def test_no_jax_import_in_package_sources():
    pkg = os.path.join(ROOT, "depthg_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                assert "import jax" not in src and "from jax" not in src, name


def test_kernel_path_raises_instead_of_falling_back():
    """The kernel launcher refuses a CPU tensor (it never runs the plain
    version), and the public wrapper refuses what the kernel cannot take."""
    qkv = torch.zeros(1, 64, 3 * 128)
    q, k, v = tatt.split_qkv(qkv, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tatt._launch(q, k, v, torch.empty_like(q), 0.125, 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tatt.attention_qkv(qkv.double(), 2, 0.125)
