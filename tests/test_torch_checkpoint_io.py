"""Checkpoints across the two packages, on the CPU.

* The JAX package's ``save_native`` writes a tiny segmenter's eval tree
  (frozen backbone included, as its trainer does) with a run config for
  ``arch=dino``, ``dino_depth`` and ``feature-pyramid``; the port's
  ``load_segmenter`` reads the orbax directory through tensorstore, and
  the segmenter's probe outputs (flip-TTA, float32) match the JAX
  package's ``eval_logits`` on the same seeded input within 1e-5 of their
  largest entry. The config comes back with its strings, bools, floats,
  ints, lists and ``None`` intact.
* A fresh interpreter reads the directory with ``jax`` never in
  ``sys.modules``; with ``sys.modules["tensorstore"] = None`` the reader
  refuses, naming the package.
* The port trainer's ``<tag>.pt`` (``save_segmenter``) round-trips for the
  three archs.
* ``finetune_zoedepth``'s ``checkpoint=`` reads the JAX package's tiny
  ZoeDepth tree from an orbax directory and from a ``.npz`` of dotted key
  paths: the state dict equals ``zoe_state_dict_from_params``'s and the
  forward matches ``zoedepth_forward`` (1e-4, as
  ``tests/test_torch_zoedepth.py``).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthg_tpu import inference as jinf
from depthg_tpu.train import step as jstep
from depthg_tpu.utils.checkpoint_io import save_native
from depthg_tpu_torch import inference as tinf
from depthg_tpu_torch.utils import checkpoint_io as tio
from depthg_tpu_torch.utils import ckpt as tckpt
from test_torch_train_variants import _configs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = {"dino": "vit", "dino_depth": "depth", "feature-pyramid": "pyramid"}
RUN_CFG = {"dataset_name": "cocostuff27", "dim": 16, "dropout": True, "lr": 5e-4,
           "n_classes": 3, "granularity": 2, "guidance": "cross_attn",
           "pretrained_weights": None, "knn_crop_types": ["five", None],
           "experiment_name": "exp name", "continuous": True}


def _jax_tree(kind):
    """The JAX trainer's checkpoint tree: ``eval_params_from_state`` with
    the frozen backbone in it (jitted init: the same values as eager)."""
    jf, tf = _configs(kind)
    hp = jstep.TrainHParams(n_classes=3)
    state = jax.jit(jstep.init_state, static_argnums=(1, 2))(jax.random.PRNGKey(0), jf, hp)
    return jf, tf, jax.tree.map(np.asarray, jstep.eval_params_from_state(state))


@pytest.fixture(scope="module")
def directories(tmp_path_factory):
    """arch -> (JAX config, port config, tree, orbax directory)."""
    root = tmp_path_factory.mktemp("orbax")
    out = {}
    for arch, kind in ARCHS.items():
        jf, tf, tree = _jax_tree(kind)
        save_native(str(root / arch), tree, dict(RUN_CFG, arch=arch),
                    extra={"metrics": {"m": 1.5}})
        out[arch] = (jf, tf, tree, str(root / arch))
    return out


@pytest.fixture(params=sorted(ARCHS))
def written(request, directories):
    return (request.param, *directories[request.param])


def _logits(model, jf, tree, tf):
    img = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)
    kw = dict(n_classes=3, run_crf=False, label_res=32)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jinf.eval_logits, static_argnums=(2, 3))(
            tree, jnp.asarray(img), jf, jinf.EvalConfig(**kw))
    with torch.no_grad():
        out = tinf.eval_logits(model, torch.from_numpy(img), tinf.EvalConfig(**kw))
    return out, ref


def test_orbax_directory_loads_and_matches_the_jax_forward(written):
    arch, jf, tf, tree, path = written
    sd, cfg = tio.load_segmenter(path)
    assert dict(cfg) == dict(RUN_CFG, arch=arch)
    assert isinstance(cfg.dropout, bool) and isinstance(cfg.lr, float)
    assert isinstance(cfg.dim, int) and cfg.pretrained_weights is None
    assert type(tinf.fcfg_from_run_cfg(cfg)).__name__ == type(tf).__name__
    model = tinf.Segmenter.from_state_dict(sd, tf)
    for got, ref in zip(*_logits(model, jf, tree, tf)):
        ref = np.asarray(ref)
        err = float(np.abs(got.numpy() - ref).max()) / float(np.abs(ref).max())
        assert err <= 1e-5, (arch, err)


def test_orbax_directories_read_without_jax(directories):
    paths = [directories[arch][-1] for arch in sorted(ARCHS)]
    code = (
        "import sys, torch\n"
        "from depthg_tpu_torch.utils.checkpoint_io import load_segmenter\n"
        f"for path in {paths!r}:\n"
        "    sd, cfg = load_segmenter(path)\n"
        "    print(sum(float(v.double().sum()) for v in sd.values()), cfg['arch'])\n"
        "assert 'jax' not in sys.modules\n"
        "assert not any(m.startswith('depthg_tpu.') for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    for line, arch, path in zip(out.stdout.splitlines(), sorted(ARCHS), paths):
        sd, _ = tio.load_segmenter(path)
        total, got_arch = line.split()
        assert got_arch == arch
        assert float(total) == sum(float(v.double().sum()) for v in sd.values())


def test_orbax_reader_names_tensorstore_when_it_is_missing(written, monkeypatch):
    path = written[-1]
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(NotImplementedError, match="tensorstore"):
        tio.load_segmenter(path)


def test_trainer_checkpoint_round_trips(written, tmp_path):
    arch, _, tf, _, path = written
    sd, cfg = tio.load_segmenter(path)
    pt = str(tmp_path / "last.pt")
    tckpt.save_segmenter(pt, sd, cfg=cfg, metrics={"test/cluster/mIoU": 12.5}, step=7)
    sd2, cfg2 = tio.load_segmenter(pt)
    assert sorted(sd2) == sorted(sd) and all(torch.equal(sd2[k], v) for k, v in sd.items())
    assert dict(cfg2) == dict(cfg)
    assert tckpt.load_segmenter_file(pt)[2] == {"test/cluster/mIoU": 12.5}
    tinf.Segmenter.from_state_dict(sd2, tf)  # strict
    with pytest.raises(ValueError, match="save_segmenter"):
        torch.save({"state_dict": sd}, str(tmp_path / "other.pt"))
        tio.load_segmenter(str(tmp_path / "other.pt"))


def _flat(tree):
    """A JAX tree as {dotted key path: array} (the ``.npz`` layout)."""
    out = {}
    for keys, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keys)
        out[name] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def zoe():
    """The JAX package's tiny ZoeDepth (its fine-tune tests' ``TINY``) and
    its metric depth on one input (both jitted: the eager values)."""
    from depthg_tpu.models.zoedepth.model import zoedepth_forward, zoedepth_init
    from depthg_tpu_torch import finetune_zoedepth as tcli
    from depthg_tpu_torch.models.zoedepth.config import DEPTH_DATASETS
    from test_zoedepth_finetune import TINY

    params = jax.tree.map(np.asarray, jax.jit(zoedepth_init, static_argnums=1)(
        jax.random.PRNGKey(0), TINY))
    spec = DEPTH_DATASETS[tcli.DEFAULTS["dataset"]]
    jcfg = dataclasses.replace(TINY, min_depth=spec.min_depth, max_depth=spec.max_depth)
    x = np.random.default_rng(1).standard_normal((1, 3, 64, 96)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, v: zoedepth_forward(p, v, jcfg)["metric_depth"])(
            params, jnp.asarray(x))
    return params, x, np.asarray(ref)


@pytest.mark.parametrize("fmt", ["orbax", "npz"])
def test_finetune_reads_the_jax_zoedepth_tree(tmp_path, fmt, zoe):
    from depthg_tpu_torch import finetune_zoedepth as tcli
    from depthg_tpu_torch.models.zoedepth.convert import zoe_state_dict_from_params

    params, x, ref = zoe
    if fmt == "orbax":
        path = str(tmp_path / "latest")
        save_native(path, params, {"dataset": "nyu", "lr": 1e-4},
                    extra={"step": 3, "metrics": {}})
    else:
        path = str(tmp_path / "params.npz")
        np.savez(path, **_flat(params))
    model = tcli.build_model(dict(tcli.DEFAULTS, checkpoint=path), torch.device("cpu"))
    ref_sd = zoe_state_dict_from_params(params)
    got_sd = model.state_dict()
    assert sorted(got_sd) == sorted(ref_sd)
    for k, v in ref_sd.items():
        assert torch.equal(got_sd[k], torch.as_tensor(np.asarray(v, np.float32))), k
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x))["metric_depth"]
    assert float(np.abs(out.numpy() - ref).max()) <= 1e-4 * float(np.abs(ref).max())
