"""The port's data-parallel paths on two gloo ranks on the CPU, against the
single process and the JAX package's sharded steps.

This file is its own worker: ``python tests/test_torch_distributed.py
--case NAME --rank R --world 2 --port P --dir D`` joins a gloo process
group on ``tcp://127.0.0.1:P``, reads ``D/inputs.pt``, runs the case and
writes ``D/rank{R}.pt``. The workers import no JAX (they run without this
suite's conftest and check ``sys.modules``); the tests start two of them
and compare what they wrote with the single-process port run here and
with JAX on a 2-device CPU mesh.

* (a) Three train steps of ``arch=dino`` (random coordinates, dropout, the
  depth term and five negatives, all drawn from the step's generator), the
  same with ``fused_pair_forward`` (one dropout draw for the stacked pair),
  ``feature-pyramid`` (the head's BatchNorm over the global batch) and
  LHP ``depth``, global batch 4, against the single process: every logged
  loss within 2e-6 relative plus 1e-7, about one float32 step of the
  O(1) correlations it averages (means of terms that cancel, summed in two
  orders: 1.25e-6 relative), and the later steps' within 1e-4 plus 1e-6
  (they move with the parameters' Adam gap below), the first step's
  gradients within 2e-6 of the largest entry of their tensor (a bias in
  front of a train-mode BatchNorm: of its conv weight; 1.2e-6 measured),
  the BatchNorm statistics after the first step within 1e-6, the
  parameters after three steps within 1e-6 of their tensor's largest
  entry plus what float64 Adam makes of the two runs' gradient
  differences (Adam divides by |g| + 1e-8: a gradient that cancels to
  rounding noise, as a bias in front of BatchNorm does, becomes an update
  of up to lr). The pyramid's gap moves its later gradients through its
  convolutions, so its parameters are held at 1e-5 plus the gap. With dropout off and the negatives'
  permutations from the JAX key, the two ranks against JAX ``train_step``
  on ``make_mesh(2)`` (``attention_impl="xla"``, as the JAX trainer pins
  it; lr 1e-4): logs 2e-5 relative (``tests/test_torch_train_step.py``),
  parameters and statistics 1e-5 plus the Adam gap of the two packages'
  gradients, JAX's recovered from its Adam moments
  (``tests/test_torch_train_variants.py``).
* (b) The eval step (default CRF point) and the predict step over a
  global batch of 4 and a tail of 3 (padded to 4 with labels -1): the
  confusion blocks and label maps equal the single process's and, without
  the CRF, JAX ``make_eval_step`` / ``make_predict_step`` on
  ``make_mesh(2)``.
* (c) ``topk_neighbors(group=)`` with N = 301, not a multiple of 2 * chunk:
  the index array equals the single process's.
* (d) The trainer CLI, then the eval CLI (``run_prediction``: rank 0
  writes the figures) and the demo CLI on ``tests/synthetic_data.py``'s
  dataset: rank 0's ``last.pt`` loads, the two ranks' eval metrics equal a
  single-process eval of it, and the demo's PNGs (global batches of 4, two
  rows a rank) equal those of one process at batch 2.
* (f) Each rank loads only its rows: a ``DataLoader``
  over 8, 7 and 5 seeded items at a global batch of 4 (shuffled) fetches
  B/W = 2 items a rank per batch and its share of the tail (7: 2 and 1;
  5: 1, and on the rank whose share is all padding one item for the
  shapes), and its batches are the rows ``shard_rows(pad_batch(...))``
  keeps of the single process's, with the global ``n_real``; the eval
  CLI and the demo CLI of (d) load half of a single process's items on
  each rank.
* (e) ``generate_depth`` with a tiny ZoeDepth, two size buckets of 4 at
  ``--batch_size 4`` (two images a rank): the PNGs are a single process's
  at batch 2 byte for byte, and within one 8-bit step of its batch-4 run
  (a forward at another batch size rounds differently).

The references and the ranks run on one thread each. Every worker case
runs in one pair of processes started by the ``ranks`` fixture.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from depthg_tpu_torch import inference as tinf  # noqa: E402
from depthg_tpu_torch.models import featurizer as tfeat  # noqa: E402
from depthg_tpu_torch.models.pyramid import PyramidConfig  # noqa: E402
from depthg_tpu_torch.models.vit import ViTConfig  # noqa: E402
from depthg_tpu_torch.parallel import dist  # noqa: E402
from depthg_tpu_torch.train import losses as tloss  # noqa: E402
from depthg_tpu_torch.train import step as tstep  # noqa: E402

B = 4
W_DF, SH = 0.19, 0.03
# test_torch_train_variants' tiny ViT (384 wide so LHP's dims line up)
VIT = dict(patch_size=8, embed_dim=384, depth=1, num_heads=2, img_size=32)
TRAIN = {  # case -> (featurizer kind, hparams, loss config of the drawn run)
    "dino": ("vit", dict(lr=1e-3), dict(feature_samples=3, neg_samples=5,
                                        depth_sampling="none",
                                        depth_feat_correlation_loss=True)),
    "pyramid": ("pyramid", dict(lr=1e-4), dict(feature_samples=3, neg_samples=2,
                                               depth_sampling="fps",
                                               depth_feat_correlation_loss=True)),
    "lhp_depth": ("vit", dict(lr=1e-3, lhp=True),
                  dict(feature_samples=3, neg_samples=2, depth_sampling="fps",
                       depth_feat_correlation_loss=True)),
    # img and img_pos as one stacked forward: a rank keeps its rows of each
    # half of the [2B] dropout draw (parallel.dist.row_blocks)
    "dino_fused_pair": ("vit", dict(lr=1e-3, fused_pair_forward=True),
                        dict(feature_samples=3, neg_samples=2, depth_sampling="none",
                             depth_feat_correlation_loss=True)),
}
JAX_LOSS = dict(feature_samples=3, neg_samples=2, depth_sampling="fps",
                depth_feat_correlation_loss=True)
JAX_LR = 1e-4


def torch_fcfg(kind, dropout=False):
    if kind == "pyramid":
        return PyramidConfig(granularity=2, dim=16, out_size=16)
    return tfeat.FeaturizerConfig(arch="vit_small", patch_size=8, dim=16,
                                  vit_config=ViTConfig(**VIT), dropout=dropout,
                                  drop_rate=0.2 if dropout else 0.0)


def train_batches(n=3, b=B, res=32):
    out = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        out.append({
            "img": rng.standard_normal((b, 3, res, res)).astype(np.float32),
            "img_pos": rng.standard_normal((b, 3, res, res)).astype(np.float32),
            "label": rng.integers(-1, 3, size=(b, res, res)),
            "depth": rng.random((b, 1, res, res)).astype(np.float32),
            "depth_pos": rng.random((b, 1, res, res)).astype(np.float32)})
    return out


def run_train(case, inputs, mode):
    """Three steps of ``case`` from ``inputs``'s weights, on this rank's
    rows (all of them outside a group). ``mode="drawn"``: every draw from
    a seeded generator, dropout on; ``"jax"``: dropout off, the negatives'
    permutations given. Returns the logs and the state dict."""
    kind, hp_kw, loss_kw = TRAIN[case]
    if mode == "jax":
        hp_kw, loss_kw = dict(hp_kw, lr=JAX_LR), JAX_LOSS
    hp = tstep.TrainHParams(n_classes=3, **hp_kw)
    lcfg = tloss.CorrLossConfig(**loss_kw)
    model = tinf.Segmenter.from_state_dict(
        inputs["sd"], torch_fcfg(kind, dropout=mode == "drawn"))
    state = tstep.state_from_model(model, hp, lhp_state_dict=inputs.get("lhp"))
    logs, grads = [], {}
    for i, batch in enumerate(inputs["batches"]):
        local = {k: dist.shard_rows(torch.from_numpy(v.copy())) for k, v in batch.items()}
        if mode == "drawn":
            out = tstep.train_step(state, local, hp, lcfg, W_DF, SH,
                                   generator=torch.Generator().manual_seed(100 + i))
        else:
            out = tstep.train_step(state, local, hp, lcfg, W_DF, SH,
                                   neg_perms=inputs["perms"][i],
                                   lhp_neg_perms=inputs["lhp_perms"][i])
        logs.append({k: float(v) for k, v in out.items()})
        for name, p in state.model.named_parameters():
            if p.grad is not None:  # the step's (averaged) gradient
                grads.setdefault(name, []).append(p.grad.detach().clone())
        if i == 0:
            stats = {k: v.clone() for k, v in state.model.state_dict().items() if ".running_" in k}
    return {"logs": logs, "grads": grads, "stats": stats,
            "sd": {k: v.detach().clone() for k, v in state.model.state_dict().items()}}


def run_eval(sd, run_crf):
    """Confusion blocks and label maps of a batch of 4 and a tail of 3 (its
    rows padded to divide over the ranks, labels -1)."""
    from depthg_tpu_torch.ops.crf import crf_config_from_cfg

    model = tinf.Segmenter.from_state_dict(sd, torch_eval_fcfg())
    img, label = eval_data()
    ecfg = tinf.EvalConfig(n_classes=5, extra_clusters=2, label_res=32, run_crf=run_crf,
                           crf=crf_config_from_cfg({}))
    group = torch.distributed.group.WORLD if dist.active() else None
    eval_step, predict = tinf.make_eval_step(ecfg, group), tinf.make_predict_step(ecfg, group)
    out = []
    for lo, hi in ((0, 4), (4, 7)):
        batch = dist.pad_batch({"img": img[lo:hi], "label": label[lo:hi]})
        x = torch.from_numpy(dist.shard_rows(batch["img"]))
        y = torch.from_numpy(dist.shard_rows(batch["label"]))
        stats = eval_step(model, x, y)
        preds = predict(model, x)
        out.append({"stats": [t.clone() for t in stats],
                    "preds": [t[:hi - lo].clone() for t in preds]})
    return out


EVAL_VIT = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)


def torch_eval_fcfg():
    return tfeat.FeaturizerConfig(vit_config=ViTConfig(**EVAL_VIT), dim=16)


def eval_data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((7, 3, 32, 32)).astype(np.float32),
            rng.integers(-1, 5, size=(7, 32, 32)))


def knn_feats():
    rng = np.random.default_rng(3)
    f = rng.standard_normal((301, 16)).astype(np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def tiny_zoe():
    from depthg_tpu_torch.models.zoedepth import ZoeConfig
    from depthg_tpu_torch.models.zoedepth.beit import BEiTConfig
    from depthg_tpu_torch.models.zoedepth.dpt import DPTConfig

    return ZoeConfig(
        n_bins=8, bin_embedding_dim=16, n_attractors=(2, 2, 1, 1), img_size=(64, 96),
        beit=BEiTConfig(embed_dim=128, depth=4, num_heads=2, pretrain_window=4,
                        hooks=(0, 1, 2, 3)),
        dpt=DPTConfig(embed_dim=128, features=16, reassemble_channels=(8, 16, 32, 32)))


def run_depth(image_dir, out, world_flag=(), batch=4):
    from depthg_tpu_torch import generate_depth

    argv = ["--data_dir", image_dir, "--output_dir", out, "--batch_size", str(batch),
            "--model", "zoedepth", "--device", "cpu", "--allow_random", "--dtype", "float32"]
    return generate_depth.main(argv + list(world_flag), zoe_config=tiny_zoe())


class CountedItems:
    """``n`` seeded items (a float image, an int label map, a name) that
    record which indices were loaded."""

    def __init__(self, n):
        self.n, self.seen = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng):
        self.seen.append(i)
        return {"img": np.float32(i) + rng.random((3, 2, 2), np.float32),
                "label": np.full((2, 2), i % 3, np.int64), "name": f"item{i}"}


FETCH_SIZES = (8, 7, 5)


def run_fetch():
    """Every batch of one shuffled epoch over each of ``FETCH_SIZES`` items
    at a global batch of ``B`` and the items fetched."""
    from depthg_tpu_torch.data import DataLoader

    out = {}
    for n in FETCH_SIZES:
        items = CountedItems(n)
        loader = DataLoader(items, B, shuffle=True, seed=3, num_workers=2)
        out[n] = {"batches": list(loader), "fetched": len(items.seen),
                  "seen": sorted(items.seen)}
    return out


def _count_items(counts):
    """Count the items the eval datasets and the demo's image folder load."""
    from depthg_tpu_torch import demo_segmentation
    from depthg_tpu_torch.data import ContrastiveSegDataset

    for cls, key in ((ContrastiveSegDataset, "dataset"),
                     (demo_segmentation.UnlabeledImageFolder, "demo")):
        def getitem(self, *args, _orig=cls.__getitem__, _key=key):
            counts[_key] += 1
            return _orig(self, *args)
        cls.__getitem__ = getitem


def cli_args(root, out, **kw):
    args = {"model_type": "vit_tiny", "dim": 16, "res": 32, "batch_size": 4,
            "num_workers": 1, "feature_samples": 3, "neg_samples": 2, "num_neighbors": 3,
            "data_dir": root, "output_root": out, "val_freq": 2, "max_steps": 2,
            "scalar_log_freq": 1, "experiment_name": "cli", "device": "cpu",
            "tensorboard_logging": False, "depth_feat_weight": 0.19,
            "depth_feat_shift": 0.03}
    args.update(kw)
    return [f"{k}={v}" for k, v in args.items()]


def eval_args(root, out, model_path):
    return [f"model_paths=[{model_path}]", f"data_dir={root}", f"output_root={out}",
            "res=32", "batch_size=2", "num_workers=1", "device=cpu", "run_prediction=True",
            "experiment_name=dist"]


def demo_args(model_path, images, out, batch):
    return [f"model_path={model_path}", f"image_dir={images}", f"output_root={out}",
            "res=32", f"batch_size={batch}", "device=cpu", "experiment_name=demo"]


def run_case(case, inputs):
    """One case of the workers, inside their process group."""
    world = torch.distributed.get_world_size()
    if case in TRAIN:
        return {mode: run_train(case, inputs[case], mode) for mode in ("drawn", "jax")}
    if case == "eval":
        return {"crf": run_eval(inputs["eval_sd"], True),
                "plain": run_eval(inputs["eval_sd"], False)}
    if case == "knn":
        from depthg_tpu_torch.parallel import knn

        return knn.topk_neighbors(knn_feats(), k=5, chunk=64, precision="highest",
                                  group=torch.distributed.group.WORLD, device="cpu")
    if case == "cli":
        from depthg_tpu_torch import demo_segmentation, eval_segmentation, train_segmentation

        root, out = inputs["cli_root"], inputs["cli_out"]
        res = train_segmentation.main(cli_args(root, out, n_devices=world))
        path = os.path.join(res["checkpoint_dir"], "last.pt")
        counts = {"dataset": 0, "demo": 0}
        _count_items(counts)
        metrics = eval_segmentation.main(eval_args(root, out, path) + [f"n_devices={world}"])
        demo = demo_segmentation.main(demo_args(path, os.path.join(inputs["images"], "val"),
                                                out, 2) + [f"n_devices={world}"])
        return {"path": path, "files": sorted(os.listdir(res["checkpoint_dir"])),
                "metrics": metrics, "demo": demo, "loaded": counts}
    if case == "fetch":
        return run_fetch()
    if case == "depth":
        return run_depth(inputs["images"], inputs["depth_out"], ["--n_devices", str(world)])
    raise ValueError(case)


CASES = sorted(TRAIN) + ["eval", "knn", "fetch", "cli", "depth"]


# -- the worker ----------------------------------------------------------------

def _worker(args) -> None:
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(args.world), RANK=str(args.rank),
                      LOCAL_RANK=str(args.rank))
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args.port}", rank=args.rank,
        world_size=args.world)
    inputs = torch.load(os.path.join(args.dir, "inputs.pt"), weights_only=False)
    for case in args.cases.split(","):
        out = run_case(case, inputs)
        path = os.path.join(args.dir, f"{case}.rank{args.rank}.pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
    theirs = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "depthg_tpu."))
              or m == "depthg_tpu"]
    assert not theirs, theirs
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    for name, typ in (("cases", str), ("rank", int), ("world", int), ("port", int),
                      ("dir", str)):
        parser.add_argument(f"--{name}", type=typ, required=True)
    _worker(parser.parse_args())
    sys.exit(0)


# -- the tests -----------------------------------------------------------------

import time  # noqa: E402

import pytest  # noqa: E402
from PIL import Image  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """The references here and the ranks each run on one thread (a
    reduction over more threads adds in another order; another test may
    have set this process's count)."""
    torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """Two worker processes running every case in turn; ``get(case)``
    waits for both ranks' results of a case."""

    def __init__(self, d: str, world: int = 2):
        self.dir, self.world = d, world
        port = _free_port()
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
        env.update(OMP_NUM_THREADS="1")
        self.procs, self.logs = [], []
        for r in range(world):
            log = open(os.path.join(d, f"rank{r}.log"), "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--cases", ",".join(CASES),
                 "--rank", str(r), "--world", str(world), "--port", str(port), "--dir", d],
                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))

    def get(self, case, timeout=240.0):
        paths = [os.path.join(self.dir, f"{case}.rank{r}.pt") for r in range(self.world)]
        deadline = time.time() + timeout
        while not all(os.path.exists(p) for p in paths):
            failed = [p for p in self.procs if p.poll() not in (None, 0)]
            if failed or time.time() > deadline:
                self.close()
                logs = "".join(open(f.name).read()[-3000:] for f in self.logs)
                pytest.fail(f"the ranks did not deliver {case}:\n{logs}")
            time.sleep(0.1)
        return [torch.load(p, weights_only=False) for p in paths]

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in self.logs:
            f.close()


def _jax_pair(kind, hp_kw):
    """A JAX ``init_state`` (jitted: the same values as the eager call) and
    the port's weights from it (test_torch_train_variants' ``pair``)."""
    import jax

    from depthg_tpu.train import step as jstep
    from depthg_tpu_torch.utils.ckpt import state_dict_from_jax
    from test_torch_train_variants import _configs

    jf, _ = _configs("pyramid" if kind == "pyramid" else "vit")
    if kind == "vit":
        jf = dataclasses.replace(jf, attention_impl="xla")  # as the JAX trainer pins it
    jhp = jstep.TrainHParams(n_classes=3, lr=JAX_LR, **hp_kw)
    jstate = jax.jit(jstep.init_state, static_argnums=(1, 2))(jax.random.PRNGKey(0), jf, jhp)
    sd = state_dict_from_jax(jstep.eval_params_from_state(jstate), keep_decoder=True)
    lhp = {k[len("lhp."):]: sd.pop(k) for k in list(sd) if k.startswith("lhp.")}
    return jf, jhp, jstate, sd, lhp or None


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs of every case, then the two workers started on all of them
    (they run while the tests compute their references)."""
    import jax

    from depthg_tpu.models import featurizer as jfeat
    from depthg_tpu.models import probes as jprobes
    from depthg_tpu.models.vit import ViTConfig as JViTConfig
    from depthg_tpu_torch.utils.ckpt import state_dict_from_jax
    from test_torch_train_cli import _dataset
    from test_torch_train_variants import _perms_from_key

    d = str(tmp_path_factory.mktemp("ranks"))
    inputs, jax_side = {}, {}
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    batches = train_batches()
    for case, (kind, hp_kw, _) in TRAIN.items():
        jf, jhp, jstate, sd, lhp = _jax_pair(kind, {k: v for k, v in hp_kw.items() if k != "lr"})
        inputs[case] = {"sd": sd, "lhp": lhp, "batches": batches,
                        "perms": [_perms_from_key(k, 2) for k in keys],
                        "lhp_perms": [_perms_from_key(k, 3) for k in keys]}
        jax_side[case] = (jf, jhp, jstate, keys)
    jf = jfeat.FeaturizerConfig(vit_config=JViTConfig(**EVAL_VIT), dim=16)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
    params = {"net": jax.jit(jfeat.featurizer_init, static_argnums=1)(k1, jf),
              "linear_probe": jprobes.linear_probe_init(k2, 16, 5),
              "cluster_probe": jprobes.cluster_lookup_init(k3, 16, 7)}
    inputs["eval_sd"] = state_dict_from_jax(params)
    jax_side["eval"] = (jf, params)
    inputs["cli_root"] = str(tmp_path_factory.mktemp("cli_data"))
    _dataset(inputs["cli_root"])
    inputs["cli_out"] = str(tmp_path_factory.mktemp("cli_out"))
    inputs["images"] = str(tmp_path_factory.mktemp("images"))
    os.makedirs(os.path.join(inputs["images"], "val"))
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate([(96, 64)] * 4 + [(64, 96)] * 4):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            os.path.join(inputs["images"], "val", f"im{i}.jpg"))
    inputs["depth_out"] = str(tmp_path_factory.mktemp("depth_out"))
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    workers = Ranks(d)
    yield workers, inputs, jax_side
    workers.close()


def _scale(tensors, name):
    """The largest entry of ``name``'s tensor or, for a conv bias in front
    of the pyramid's train-mode BatchNorm (``net.convK.convJ.bias``, whose
    gradient is zero in exact arithmetic), of its weight."""
    if name.startswith("net.conv") and name.endswith(".bias"):
        name = name[:-len(".bias")] + ".weight"
    return max(float(tensors[name].abs().max()), 1e-12)


def _adam_gap(out_grads, ref_grads, name, lr):
    """How far float64 Adam carries parameter ``name`` apart on the two
    runs' gradient sequences (a running mean takes its conv bias's)."""
    from test_torch_train_variants import _adam

    if name.endswith(".running_mean"):  # net.convK.bnJ -> net.convK.convJ.bias
        head, bn, _ = name.rsplit(".", 2)
        name = f"{head}.conv{bn[2:]}.bias"
    if name not in ref_grads or name not in out_grads:
        return 0.0
    return (_adam([g.double() for g in out_grads[name]], lr)
            - _adam([g.double() for g in ref_grads[name]], lr)).abs()


def _hold_params(out_sd, ref_sd, out_grads, ref_grads, lr, rel=None, atol=0.0,
                 stats=True):
    """Parameters (and BatchNorm statistics unless ``stats=False``): within
    ``rel`` of the largest entry of their tensor (or ``atol``), plus the
    Adam gap."""
    for name, ref in ref_sd.items():
        if (name.endswith("num_batches_tracked") or name.startswith("net.model.")
                or (not stats and ".running_" in name)):
            continue
        tol = atol if rel is None else rel * max(float(ref.abs().max()), 1e-12)
        diff = (out_sd[name].double() - ref.double()).abs()
        bad = diff > tol + _adam_gap(out_grads, ref_grads, name, lr)
        assert not bool(bad.any()), (name, float(diff.max()), int(bad.sum()))


def _jax_mesh_run(jf, jhp, jstate, keys, batches):
    """JAX ``train_step`` with the state replicated and each batch sharded
    over a 2-device mesh, as the JAX trainer runs it: the logs, each step's
    gradients (recovered from Adam's first moment, mu_t = 0.9 mu_t-1 +
    0.1 g_t, which saves compiling a second program) and the parameters."""
    import jax
    import jax.numpy as jnp

    from depthg_tpu.parallel import mesh as mesh_lib
    from depthg_tpu.train import losses as jloss
    from depthg_tpu.train import step as jstep
    from test_torch_train_variants import _to_torch_layout

    def first_moments(state):
        opt = state["opt"]
        return {"net": opt["net"][0].mu["net"], "linear_probe": opt["linear"][0].mu,
                "cluster_probe": opt["cluster"][0].mu,
                "decoder": state["params"]["decoder"]}

    mesh = mesh_lib.make_mesh(2)
    state = mesh_lib.replicate(jstate, mesh)
    jl = jloss.CorrLossConfig(**JAX_LOSS)
    step = jax.jit(lambda s, b, k: jstep.train_step(s, b, k, jf, jhp, jl, W_DF, SH))
    logs, grads = [], {}
    for batch, key in zip(batches, keys):
        jb = mesh_lib.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
        before = first_moments(state)
        state, out = step(state, jb, key)
        logs.append({k: float(v) for k, v in out.items() if k != "aux/bn_stats"})
        g = jax.tree_util.tree_map(lambda new, old: (new - 0.9 * old) / 0.1,
                                   first_moments(state), before)
        for name, v in _to_torch_layout(state, g).items():
            grads.setdefault(name, []).append(v)
    return logs, grads, _to_torch_layout(state, state["params"])


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_two_ranks_train_like_one_process_and_like_jax_on_a_mesh(case, ranks):
    workers, inputs, jax_side = ranks
    ref_logs, ref_grads, ref_params = _jax_mesh_run(*jax_side[case], inputs[case]["batches"])
    singles = {mode: run_train(case, inputs[case], mode) for mode in ("drawn", "jax")}
    out = workers.get(case)
    assert all(torch.equal(out[0]["drawn"]["sd"][k], v)
               for k, v in out[1]["drawn"]["sd"].items())  # one model on every rank
    for mode, single in singles.items():
        lr = JAX_LR if mode == "jax" else TRAIN[case][1]["lr"]
        got = out[0][mode]
        # from the second step on the losses move with the weights' Adam gap
        for step, (a, b) in enumerate(zip(got["logs"], single["logs"])):
            assert sorted(a) == sorted(b)
            rel, floor = (2e-6, 1e-7) if step == 0 else (1e-4, 1e-6)
            for name in b:
                assert abs(a[name] - b[name]) <= rel * abs(b[name]) + floor, \
                    (mode, step, name, a[name], b[name])
        ref_g = {k: v[0] for k, v in single["grads"].items()}
        for name, g in ref_g.items():
            err = float((got["grads"][name][0] - g).abs().max())
            assert err <= 2e-6 * _scale(ref_g, name), (mode, name, err)
        for name, ref in single["stats"].items():
            err = float((got["stats"][name] - ref).abs().max())
            assert err <= 1e-6 * max(float(ref.abs().max()), 1e-12), (mode, name, err)
        # the statistics after step 1 above; later ones follow the weights'
        # Adam gap through every input channel of their convolution, which
        # also moves the pyramid's later gradients beyond rounding
        _hold_params(got["sd"], single["sd"], got["grads"], single["grads"], lr,
                     rel=1e-5 if case == "pyramid" else 1e-6, stats=False)
    got = out[0]["jax"]
    for step, (a, b) in enumerate(zip(got["logs"], ref_logs)):
        for name in b:
            np.testing.assert_allclose(a[name], b[name], rtol=2e-5, atol=1e-7,
                                       err_msg=f"step {step} {name}")
    _hold_params(got["sd"], ref_params, got["grads"], ref_grads, JAX_LR, atol=1e-5)


def test_two_ranks_eval_and_predict_like_one_process_and_like_jax(ranks):
    import jax.numpy as jnp

    from depthg_tpu import inference as jinf
    from depthg_tpu.parallel import mesh as mesh_lib

    workers, inputs, jax_side = ranks
    jf, params = jax_side["eval"]
    ecfg = jinf.EvalConfig(n_classes=5, extra_clusters=2, label_res=32, run_crf=False)
    mesh = mesh_lib.make_mesh(2)
    jeval, jpredict = jinf.make_eval_step(jf, ecfg, mesh), jinf.make_predict_step(jf, ecfg, mesh)
    img, label = eval_data()
    singles = {"crf": run_eval(inputs["eval_sd"], True),
               "plain": run_eval(inputs["eval_sd"], False)}
    out = workers.get("eval")
    for key, single in singles.items():
        for rank_out in out:
            for got, ref in zip(rank_out[key], single):
                for a, b in zip(got["stats"] + got["preds"], ref["stats"] + ref["preds"]):
                    assert torch.equal(a, b), key
    for (lo, hi), got in zip(((0, 4), (4, 7)), out[0]["plain"]):
        x, y = img[lo:hi], label[lo:hi]
        if hi - lo == 3:  # the JAX CLI's padding of a tail to the mesh
            x = np.concatenate([x, np.zeros_like(x[:1])])
            y = np.concatenate([y, np.full_like(y[:1], -1)])
        stats = jeval(params, jnp.asarray(x), jnp.asarray(y))
        preds = jpredict(params, jnp.asarray(x))
        for a, b in zip(got["stats"], stats):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(got["preds"], preds):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:hi - lo])


def test_two_ranks_topk_neighbors_equal_one_process(ranks):
    from depthg_tpu_torch.parallel import knn

    workers, _, _ = ranks
    ref = knn.topk_neighbors(knn_feats(), k=5, chunk=64, precision="highest", device="cpu")
    for out in workers.get("knn"):
        np.testing.assert_array_equal(out, ref)
    assert 301 % (2 * 64)
    with pytest.raises(ValueError, match="process group"):
        knn.topk_neighbors(knn_feats(), k=5, group=object(), device="cpu")


def test_two_ranks_train_eval_and_demo_clis_like_one_process(ranks, tmp_path):
    from depthg_tpu_torch import eval_segmentation

    workers, inputs, _ = ranks
    out = workers.get("cli")
    path = out[0]["path"]
    assert out[1]["path"] == path and os.path.exists(path)
    assert {"last.pt", "last.ckpt", "last.train_state.pt", "best.pt"} <= set(out[0]["files"])
    single = eval_segmentation.main(eval_args(inputs["cli_root"], str(tmp_path), path))
    for rank_out in out:
        got = rank_out["metrics"][path]
        for k, v in single[path].items():
            if k not in ("images_per_sec_end_to_end", "device"):
                assert got[k] == v or (np.isnan(got[k]) and np.isnan(v)), k
    # the demo's global batches of 4 run as 2 rows a rank: a single
    # process at batch 2 writes the same PNGs
    from depthg_tpu_torch import demo_segmentation

    single_demo = demo_segmentation.main(demo_args(path, os.path.join(inputs["images"], "val"),
                                                   str(tmp_path), 1))
    for sub in ("linear", "cluster"):
        names = sorted(os.listdir(os.path.join(single_demo, sub)))
        assert len(names) == 8
        for name in names:
            with open(os.path.join(out[0]["demo"], sub, name), "rb") as f:
                with open(os.path.join(single_demo, sub, name), "rb") as g:
                    assert f.read() == g.read(), (sub, name)
    pred = os.path.join(inputs["cli_out"], "predictions", "dist")
    for name in ("confusion.png", "prediction_grid.png", "confusion.npz"):
        assert os.path.exists(os.path.join(pred, name)), name
    with open(os.path.join(inputs["cli_out"], "eval_metrics.json")) as f:
        assert path in f.read()


def test_two_ranks_generate_depth_pngs_of_one_process(ranks, tmp_path):
    """Each bucket's dispatch of 4 runs as 2 images a rank: the PNGs are
    those a single process writes at batch 2 byte for byte, and within one
    8-bit step of its batch-4 run (a forward at another batch size rounds
    differently)."""
    workers, inputs, _ = ranks
    n = run_depth(inputs["images"], str(tmp_path / "b2"), batch=2)
    run_depth(inputs["images"], str(tmp_path / "b4"), batch=4)
    assert workers.get("depth") == [n, n] == [8, 8]
    for p in sorted((tmp_path / "b2" / "val").glob("*.png")):
        got = os.path.join(inputs["depth_out"], "val", p.name)
        assert open(got, "rb").read() == p.read_bytes(), p.name
        whole = np.asarray(Image.open(tmp_path / "b4" / "val" / p.name), np.int16)
        assert np.abs(np.asarray(Image.open(got), np.int16) - whole).max() <= 1, p.name


def test_two_ranks_load_only_their_rows(ranks):
    """Each rank fetches B/W items of every global batch and its share of
    the tail, and holds exactly the rows the single process's padded batch
    gives it; the eval and demo CLIs load half a single process's items on
    each rank."""
    workers, _, _ = ranks
    single = run_fetch()
    out = workers.get("fetch")
    for n in FETCH_SIZES:
        ref = single[n]
        assert ref["fetched"] == n and ref["seen"] == list(range(n))
        tail = n % B
        share = -(-tail // 2)  # the tail padded to divide over 2 ranks
        want = [(n // B) * B // 2 + share, (n // B) * B // 2 + tail - share]
        if tail and tail == share:  # rank 1's share of the tail is all padding:
            want[1] += 1  # it loads the tail's first item once for the shapes
        assert [o[n]["fetched"] for o in out] == want, (n, want)
        assert sorted(set(out[0][n]["seen"]) | set(out[1][n]["seen"])) == list(range(n))
        for r, rank_out in enumerate(out):
            assert len(rank_out[n]["batches"]) == len(ref["batches"])
            for got, whole in zip(rank_out[n]["batches"], ref["batches"]):
                n_real = len(whole["img"])
                pad = n_real % 2  # pad_batch's rows at a world of 2
                padded = {k: np.concatenate([whole[k], np.full((pad, *whole[k].shape[1:]),
                                                               fill, whole[k].dtype)])
                          for k, fill in (("img", 0), ("label", -1))}
                m = len(padded["img"]) // 2
                assert got["n_real"] == n_real
                for k in ("img", "label"):
                    np.testing.assert_array_equal(got[k], padded[k][r * m:(r + 1) * m])
                assert got["name"] == whole["name"][r * m:min((r + 1) * m, n_real)]
    # the eval CLI over the 2 val images (the metrics pass, then the first
    # batch again for the figures) and the demo over 8 images: a single
    # process loads 4 and 8 items, each rank half of them
    for rank_out in workers.get("cli"):
        assert rank_out["loaded"] == {"dataset": 2, "demo": 4}
