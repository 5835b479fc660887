"""The port's bench (``depthg_tpu_torch.bench``) and profiling helpers
(``depthg_tpu_torch.utils.profiling``) on the CPU.

* The workload is the JAX bench's: each eval point's CRF config,
  featurizer and sizes, the train phase's hparams, loss config and
  depth-feature weights, and the IO phase's sizes, in full and smoke mode
  (root ``bench.py`` imports no JAX at module level; its literal sizes are
  read from its source).
* One smoke-size eval step of the bench's setup (ViT-S/8 at full width,
  128 px, batch 2, the default CRF point) from JAX weights carried over
  through the Lightning layout gives the JAX step's confusion blocks on the
  same numpy inputs: in float32 within the tolerance of
  ``test_torch_eval_step.py`` (the same totals, an L1 difference of at most
  0.2% of them), in the bench's bf16 with the same totals and an L1 within
  ``BF16_CONFUSION_L1`` (2.5%).
* The orchestrator in a subprocess with injected faults falls back and
  still reports; without ``--device cpu`` on a host without a card it
  exits 1 with the error line.
* ``benchmark/counting.py``'s featurizer count (the yardstick of the
  ``mfu.*`` metrics) equals ``FlopCounterMode`` on the port's forward, for
  ViT-S/8 and ViT-B/8 at their published widths.
* ``median_time`` and ``dispatch_rtt``.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common, counting
from depthg_tpu_torch import bench as tbench
from depthg_tpu_torch import inference as tinf
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH_PATH = os.path.join(ROOT, "bench.py")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench_module", JAX_BENCH_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _function(name):
    with open(JAX_BENCH_PATH) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _smoke_or_full(node):
    """(smoke, full) literals of ``A if SMOKE else B``, else None."""
    if isinstance(node, ast.IfExp) and ast.unparse(node.test) == "SMOKE":
        return ast.literal_eval(node.body), ast.literal_eval(node.orelse)
    return None


def _jax_sizes(func):
    """Every ``name = A if SMOKE else B`` in a JAX bench function, and the
    batches of its ``for bsz in A if SMOKE else B`` sweep."""
    out = {}
    for node in ast.walk(_function(func)):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name) and _smoke_or_full(node.value)):
            out[node.targets[0].id] = _smoke_or_full(node.value)
        if isinstance(node, ast.For) and _smoke_or_full(node.iter):
            out["sweep"] = _smoke_or_full(node.iter)
    return out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("point", tbench.EVAL_POINTS)
def test_eval_workload_is_the_jax_benchs(monkeypatch, point, smoke):
    jb = _jax_bench()
    assert tbench.EVAL_POINTS == jb.EVAL_POINTS
    assert tbench.BASELINE_IMG_PER_SEC_EST == jb.BASELINE_IMG_PER_SEC_EST
    monkeypatch.setattr(jb, "SMOKE", smoke)
    fj, ej, rj = jb._eval_setup(point)
    ft, et, rt = tbench._eval_setup(point, smoke=smoke)
    assert rt == rj and et.label_res == ej.label_res == rj
    for name in ("arch", "patch_size", "dim", "attention_impl"):
        assert getattr(ft, name) == getattr(fj, name), name
    for f in dataclasses.fields(et):
        if f.name != "crf":
            assert getattr(et, f.name) == getattr(ej, f.name), f.name
    for f in dataclasses.fields(et.crf):
        assert getattr(et.crf, f.name) == getattr(ej.crf, f.name), f.name
    want = {k: v[0 if smoke else 1] for k, v in _jax_sizes("phase_eval").items()}
    sizes = tbench.eval_sizes(smoke)
    assert (sizes["batch"], sizes["iters"], sizes["sweep"]) == (
        want["batch"], want["iters"], want["sweep"])
    assert (sizes["pipelined"], sizes["resident"]) == (want["K"], want["n_res"])


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_train_and_io_workload_is_the_jax_benchs(smoke):
    from depthg_tpu.models.featurizer import FeaturizerConfig as JF
    from depthg_tpu.train import losses as jloss
    from depthg_tpu.train import step as jstep

    fcfg, hps, lcfg, w, shift = tbench._train_setup()
    func = _function("phase_train")
    calls = {ast.unparse(n.func): n for n in ast.walk(func) if isinstance(n, ast.Call)}
    env = {"step_lib": jstep, "loss_lib": jloss, "FeaturizerConfig": JF}
    jf = eval(ast.unparse(calls["FeaturizerConfig"]), env)
    for name in ("arch", "patch_size", "dim", "attention_impl"):
        assert getattr(fcfg, name) == getattr(jf, name), name
    jl = eval(ast.unparse(calls["loss_lib.CorrLossConfig"]), env)
    assert dataclasses.asdict(lcfg) == dataclasses.asdict(jl)
    jhps = [eval(ast.unparse(n), env) for n in ast.walk(func)
            if isinstance(n, ast.Call) and ast.unparse(n.func) == "step_lib.TrainHParams"]
    assert sorted(h.backbone_dtype for h in jhps) == sorted(hps)
    for jh in jhps:
        assert dataclasses.asdict(hps[jh.backbone_dtype]) == dataclasses.asdict(jh)
    step_args = calls["step_lib.train_step"].args
    assert (w, shift) == tuple(ast.literal_eval(a) for a in step_args[-2:])
    want = {k: v[0 if smoke else 1] for k, v in _jax_sizes("phase_train").items()}
    assert tbench.train_sizes(smoke) == {"res": want["res"], "batch": want["batch"],
                                    "iters": want["iters"]}
    want = {k: v[0 if smoke else 1] for k, v in _jax_sizes("phase_io").items()}
    assert tbench.io_sizes(smoke) == {"res": want["res"], "batch": want["batch"]}


# the bench's own bf16 step against the JAX bf16 step: bf16 rounding in 12
# blocks moves the pre-CRF logits by ~1% of their scale between the two
# frameworks (float32: 1e-6), so ~1% of the labels differ (0.99% and 1.29%
# L1 on this input); the float32 step is held to the eval-step tolerance
BF16_CONFUSION_L1 = 0.025


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_smoke_eval_step_matches_jax(monkeypatch, precision):
    """The bench's default point at smoke size (full-width ViT-S/8, 128 px,
    batch 2, the int8 kernel cache) from one set of JAX weights, on the
    same numpy inputs. ``float32`` (backbone and CRF state, the precision
    ``test_torch_eval_step.py`` holds) gives the JAX step's confusion
    blocks within that file's tolerance: the same totals and an L1
    difference of at most 0.2% of them. ``bfloat16`` is the bench's own
    step: the same totals, L1 within ``BF16_CONFUSION_L1``."""
    import jax
    import jax.numpy as jnp

    from depthg_tpu.inference import predictions
    from depthg_tpu.utils.metrics import confusion_update as jconfusion
    from depthg_tpu_torch.utils.ckpt import state_dict_from_jax

    jb = _jax_bench()
    monkeypatch.setattr(jb, "SMOKE", True)
    fj, ej, res = jb._eval_setup("default")
    ft, et, _ = tbench._eval_setup("default", smoke=True)
    assert et.backbone_dtype == et.crf.dtype == "bfloat16"
    ej, et = (dataclasses.replace(e, backbone_dtype=precision,
                                  crf=dataclasses.replace(e.crf, dtype=precision))
              for e in (ej, et))
    batch = tbench.eval_sizes(smoke=True)["batch"]
    params = jb._eval_params(fj)
    model = tinf.Segmenter.from_state_dict(state_dict_from_jax(params), ft)
    rng = np.random.default_rng(0)
    img = rng.standard_normal((batch, 3, res, res)).astype(np.float32)
    label = rng.integers(-1, 27, size=(batch, res, res)).astype(np.int32)

    @jax.jit
    def jax_stats(params, img, label):
        lin, clu = predictions(params, img, fj, ej)
        return jconfusion(lin, label, 27, 0), jconfusion(clu, label, 27, 0)

    ref = jax_stats(params, jnp.asarray(img), jnp.asarray(label))
    out = tinf.make_eval_step(et)(model, torch.from_numpy(img), torch.from_numpy(label))
    labelled = int(((label >= 0) & (label < 27)).sum())
    limit = 0.002 if precision == "float32" else BF16_CONFUSION_L1
    for sj, st in zip(ref, out):
        sj, st = np.asarray(sj).astype(np.int64), st.numpy()
        assert st.shape == sj.shape == (27, 27)
        assert st.sum() == sj.sum() == labelled
        assert np.abs(st - sj).sum() <= limit * sj.sum()


def _run_bench(args, env_extra, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2", **env_extra})
    return subprocess.run([sys.executable, "-m", "depthg_tpu_torch.bench", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_orchestrator_falls_back_and_still_reports():
    """The default eval child and the train child die (exit 42): the next
    point is the headline, the other three points are measured, the
    reasons are recorded, and the run still exits 0."""
    r = _run_bench(["--device", "cpu"], {"BENCH_SMOKE": "1",
                                         "BENCH_FAULT_INJECT": "eval:default,train:default",
                                         "BENCH_PHASE_TIMEOUT_S": "200"})
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["operating_point"] == "quality_plus"
    assert out["value"] == out["points_img_per_sec"]["quality_plus"] > 0
    assert set(out["points_img_per_sec"]) == {"quality_plus", "fast", "safe"}
    assert set(out["k1_launches_per_step"]) == {"quality_plus", "fast", "safe"}
    assert all(n == 0 for n in out["k1_launches_per_step"].values())  # no kernel on the CPU
    assert len(out["eval_fallback_reason"]) == 1
    assert out["eval_fallback_reason"][0].startswith("default: rc=42")
    assert "rc=42" in out["train_error"]
    assert out["host_img_per_sec"] > 0
    assert out["pipelined_img_per_sec"] > 0 and out["device_put_latency_ms"] > 0
    assert out["device"] == "cpu" and out["vs_baseline"] is not None


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("point", tbench.EVAL_POINTS)
def test_headline_on_the_card_needs_the_attention_kernel(point, device_type):
    """On the card only a point through the attention kernel may head (not
    ``safe``, eager attention); on the CPU every point may."""
    want = device_type == "cpu" or point != "safe"
    assert tbench.heads_on(point, device_type) == want


# a child's reply by point on a simulated card: (rc, K1 launches per step)
CARD_RUNS = {
    # every kernel point's child dies: only ``safe`` (0 launches) is measured
    "kernel_points_fail": {"default": (42, 24), "quality_plus": (42, 24),
                           "fast": (42, 24), "safe": (0, 0)},
    # the default's child ran the plain attention: a fault, the next point heads
    "default_without_the_kernel": {"default": (0, 0), "quality_plus": (0, 24),
                                   "fast": (0, 24), "safe": (0, 0)},
}


@pytest.mark.parametrize("case", sorted(CARD_RUNS))
def test_orchestrator_on_the_card_never_heads_with_plain_attention(monkeypatch, capsys, case):
    """The orchestrator on a simulated card (the children's replies
    stubbed): a point without an attention-kernel launch never carries the
    headline, and with no kernel point measured the run exits 1 with
    ``value`` null, every point still reported."""
    from depthg_tpu_torch import runtime

    calls = []

    def child(args, device, timeout_s):
        calls.append(args)
        if args[1] != "eval":
            return 0, {}, ""
        rc, k1 = CARD_RUNS[case][args[3]]
        frag = {"value": 10.0 + len(calls), "k1_launches_per_step": k1}
        return (rc, frag, "") if rc == 0 else (rc, None, "killed")

    monkeypatch.setattr(runtime, "get_device", lambda name: torch.device("cuda"))
    monkeypatch.setattr(tbench, "_card", lambda dev: "a card")
    monkeypatch.setattr(tbench, "_run_child", child)
    rc = tbench.orchestrate("cuda")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    full = [a[3] for a in calls if "--full" in a]
    assert "safe" not in full and out["device"] == "a card"
    if case == "kernel_points_fail":
        assert rc == 1 and out["value"] is None and out["vs_baseline"] is None
        assert "operating_point" not in out and full == ["default", "quality_plus", "fast"]
        assert out["points_img_per_sec"] == {"safe": 14.0}
        assert out["k1_launches_per_step"] == {"safe": 0}
        assert len(out["eval_fallback_reason"]) == 4
        assert "no headline" in out["eval_fallback_reason"][-1]
    else:
        assert rc == 0 and out["operating_point"] == "quality_plus"
        assert out["value"] == out["points_img_per_sec"]["quality_plus"] == 12.0
        assert set(out["points_img_per_sec"]) == {"quality_plus", "fast", "safe"}
        assert out["eval_fallback_reason"] == ["default: no attention-kernel launch on the card"]


def test_bench_refuses_without_a_card():
    """Without ``--device cpu`` the bench asks for the card, prints the error
    line and exits 1 before any phase runs."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    r = _run_bench([], {"BENCH_SMOKE": "1"}, timeout=120)
    assert r.returncode == 1
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["value"] is None and "CUDA" in out["error"]
    assert "eval point" not in r.stderr
    r = _run_bench(["--phase", "io"], {"BENCH_SMOKE": "1"}, timeout=120)
    assert r.returncode != 0 and "torch.cuda.is_available() is False" in r.stderr


@pytest.mark.parametrize("res", [64, 128])
@pytest.mark.parametrize("name", ["depthg-vits8-cocostuff27", "depthg-vitb8-cocostuff27"])
def test_featurizer_count_is_the_flop_counters(name, res):
    """``benchmark/counting.py``'s operations of one image through the ViT
    and the projection head, from the configuration's widths, equal
    ``FlopCounterMode`` over the port's featurizer forward (the eager
    attention on the CPU: its two products) at batch 2."""
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    net = tfeat.build(common.featurizer_config(cfg))
    net = net.init_weights(torch.Generator().manual_seed(0)).eval()
    img = torch.randn(2, 3, res, res, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        tfeat.dispatch_apply(net, img)
    want = 2 * (counting.vit_flops(cfg["backbone"], res) + counting.head_flops(cfg, res))
    assert counter.get_total_flops() == want


def test_step_timer_log_jsonl_median_time_and_trace():
    """``median_time`` and ``dispatch_rtt`` on the CPU."""
    calls = []
    assert profiling.median_time(lambda: calls.append(1), repeats=3) >= 0 and len(calls) == 3
    assert profiling.dispatch_rtt("cpu", repeats=2) >= 0
