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
* ``step_flops``: each counted function's work equals ``FlopCounterMode``
  of a float64 product formulation, its plain version's products are not
  counted again, and one eval step counts the same through the kernel's
  entry (``attention_impl="fused"``, the card's path) as through the eager
  attention (the CPU's ``auto``), and with the counted int8 cache as with
  its eager build seen by ``FlopCounterMode``.
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

from depthg_tpu_torch import bench as tbench
from depthg_tpu_torch import inference as tinf
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.models import layers
from depthg_tpu_torch.models import vit as tvit
from depthg_tpu_torch.ops import attention as tatt
from depthg_tpu_torch.ops import crf as tcrf
from depthg_tpu_torch.ops import crf_bilateral as tbil
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
    assert out["eval_hw_util"] is None and out["eval_tflops_per_sec"] is None
    assert out["eval_step_flops"] > 0 and out["host_img_per_sec"] > 0
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


def _counted(fn, *args):
    return profiling.step_flops(fn, *args)


def _flop_counter(fn):
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


@pytest.mark.parametrize("n_valid", [None, 37])
def test_attention_counts_its_work_once(n_valid):
    b, h, n, d = 2, 3, 45, 64
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, n, 3 * h * d, generator=g)
    nv = n if n_valid is None else n_valid
    q, k, v = (x.double() for x in tatt.split_qkv(qkv, h))
    # a float64 formulation: q k^T over the keys that weigh, then P v
    ref = _flop_counter(lambda: (q @ k[:, :, :nv].transpose(-1, -2)).softmax(-1)
                        @ v[:, :, :nv])
    assert profiling.attention_flops(b, h, n, nv, d) == ref
    assert _counted(tatt.attention_qkv, qkv, h, d ** -0.5, n_valid) == ref
    # the plain version alone is ordinary tensor ops: FlopCounterMode sees them
    assert _counted(tatt.attention_plain, *tatt.split_qkv(qkv, h), d ** -0.5, n_valid) > 0


@pytest.mark.parametrize("c", [1, 27])
def test_bilateral_message_and_degree_count_their_work_once(c):
    b, n = 2, 70
    g = torch.Generator().manual_seed(1)
    feats = torch.randn(b, n, 5, generator=g)
    values = torch.randn(b, n, c, generator=g)
    f = feats.double()
    sq = (f * f).sum(-1, keepdim=True)
    ones, zeros = torch.ones_like(sq), torch.zeros(b, n, 1, dtype=torch.float64)
    # the exponent as one product over the features augmented to 8
    a = torch.cat([f, -0.5 * sq, ones, zeros], -1)
    bb = torch.cat([f, ones, -0.5 * sq, zeros], -1)
    exponent = _flop_counter(lambda: torch.bmm(a, bb.transpose(1, 2)))
    kmat = torch.exp(torch.bmm(a, bb.transpose(1, 2)))
    product = _flop_counter(lambda: torch.bmm(kmat, values.double()))
    assert profiling.bilateral_message_flops(b, n, c) == exponent + product
    assert _counted(tbil.bilateral_message, feats, values) == exponent + product
    # the degree K 1: the exponent and one add per entry of K
    assert profiling.bilateral_degree_flops(b, n) == exponent + kmat.numel()
    assert _counted(tbil.bilateral_degree, feats) == exponent + kmat.numel()


def test_int8_products_count_their_work_once():
    g = torch.Generator().manual_seed(2)
    kmat = torch.randint(-127, 128, (2, 40, 40), generator=g).to(torch.int8)
    z8 = torch.randint(-127, 128, (2, 40, 27), generator=g).to(torch.int8)
    ref = _flop_counter(lambda: torch.bmm(kmat.double(), z8.double()))
    assert _counted(tcrf._int8_matmul, kmat, z8) == ref
    for m in (5, 40):  # fewer than 17 rows are padded; the padding is not counted
        a = torch.randint(-127, 128, (m, 32), generator=g).to(torch.int8)
        w = torch.randint(-127, 128, (24, 32), generator=g).to(torch.int8)
        ref = _flop_counter(lambda: a.double() @ w.double().T)
        assert profiling.int8_matmul_flops(m, 32, 24) == ref
        assert _counted(layers.int8_matmul, a, w) == ref
        assert _flop_counter(lambda: layers.int8_matmul(a, w)) == 0  # _int_mm counts 0


def test_int8_cache_counts_its_work_once():
    """The int8 cache counts the eager build's [N, 5] x [5, N] product per
    image once, as ``FlopCounterMode`` counts it in float64; its own
    tensor ops are not counted again."""
    b, n = 3, 50
    feats = torch.randn(b, n, 5, generator=torch.Generator().manual_seed(4))
    f = feats.double()
    ref = sum(_flop_counter(lambda: f[i] @ f[i].T) for i in range(b))
    assert profiling.bilateral_cache_flops(b, n) == ref == 2 * b * n * n * 5
    assert _counted(tcrf.cache_kernel_int8, feats) == ref


def test_eval_step_counts_the_same_with_the_counted_cache(monkeypatch):
    """An eval step at the default point (int8 cache) counts what it counted
    when ``FlopCounterMode`` saw the eager build's product itself."""
    cfg = tvit.ViTConfig(embed_dim=128, depth=2, num_heads=2)
    ecfg = tinf.EvalConfig(n_classes=5, extra_clusters=2, label_res=64,
                           crf=tcrf.crf_config_from_cfg({}), backbone_dtype="bfloat16")
    g = torch.Generator().manual_seed(5)
    img = torch.randn(2, 3, 64, 64, generator=g)
    label = torch.randint(-1, 5, (2, 64, 64), generator=g)
    fcfg = tfeat.FeaturizerConfig(vit_config=cfg, dim=16)
    model = tinf.Segmenter(fcfg, 5, 7).init_weights(torch.Generator().manual_seed(0))
    step = tinf.make_eval_step(ecfg)
    counted = profiling.step_flops(step, model, img, label)
    monkeypatch.setattr(tcrf, "cache_kernel_int8", tcrf.cache_kernel_int8_plain)
    assert profiling.step_flops(step, model, img, label) == counted


def test_eval_step_counts_the_same_through_the_kernels_entry():
    """A tiny eval step (int8 CRF cache) counts the same on two calls, and
    through ``attention_qkv`` (the card's path) as through the eager
    attention (the CPU's), so a count taken on the CPU is the card's."""
    cfg = tvit.ViTConfig(embed_dim=128, depth=2, num_heads=2)
    ecfg = tinf.EvalConfig(n_classes=5, extra_clusters=2, label_res=64,
                           crf=tcrf.crf_config_from_cfg({}), backbone_dtype="bfloat16")
    g = torch.Generator().manual_seed(3)
    img = torch.randn(2, 3, 64, 64, generator=g)
    label = torch.randint(-1, 5, (2, 64, 64), generator=g)
    counts = {}
    for impl in ("auto", "fused"):
        fcfg = tfeat.FeaturizerConfig(vit_config=cfg, dim=16, attention_impl=impl)
        model = tinf.Segmenter(fcfg, 5, 7).init_weights(torch.Generator().manual_seed(0))
        step = tinf.make_eval_step(ecfg)
        counts[impl] = [profiling.step_flops(step, model, img, label) for _ in range(2)]
    assert counts["auto"][0] == counts["auto"][1] == counts["fused"][0] == counts["fused"][1]
    tokens = (64 // 8) ** 2 + 1
    attention = 2 * 2 * profiling.attention_flops(2, 2, tokens, tokens, 64)  # TTA x blocks
    assert counts["auto"][0] > attention


def test_step_timer_log_jsonl_median_time_and_trace():
    """``median_time`` and ``dispatch_rtt`` on the CPU."""
    calls = []
    assert profiling.median_time(lambda: calls.append(1), repeats=3) >= 0 and len(calls) == 3
    assert profiling.dispatch_rtt("cpu", repeats=2) >= 0
