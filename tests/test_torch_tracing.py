"""The port's spans (``depthg_tpu_torch.utils.profiling``) and the
benchmark's readers of them, on the CPU.

* Off (no profiler, outside ``recording()``) a span is one shared null
  context: the tiny eval and train steps run with ``torch.cuda.Event`` and
  ``torch.profiler.record_function`` made to raise, record nothing, and a
  span allocates nothing.
* On: the parent is the innermost open span of the same thread, every span
  under one outermost span shares its step id, self time is the span less
  its children, the K1 counter's delta is the kernel's own
  ``KERNEL.launches`` delta, the int8 cache, int8 message, bins tail and
  SwiGLU gate kernels' counters are recorded as deltas too (every span of
  the depth step carries the bins tail's, every span of the DINOv2 eval
  step the gate's, 0 on the CPU), and the host stamps bracket a
  profiler event recorded inside (one clock, ``time.time_ns()``). A running
  ``torch.profiler`` turns recording on by itself.
* ``host_sync`` is one on the ``host_syncs`` counter (registered by
  ``utils.profiling`` itself) in every span open around it, and off it is
  the shared null context: no counter read, no allocation.
* The tiny eval, predict and train steps (the sizes of
  ``test_torch_eval_step.py`` and ``test_torch_train_step.py``) and the
  depth steps of ``generate_depth.build`` on a tiny ZoeDepth and a tiny
  Depth Anything V2 (one ``backbone``, ``dpt`` and ``out_head`` a step)
  emit exactly their span trees (eval: ``logits`` > ``backbone``, ``crf``,
  ``confusion`` (the argmaxes) and ``confusion`` (the blocks), with their
  ``host_sync`` spans) and count their
  ``host_sync`` calls (7 an eval step, 1 a train step, none a depth step);
  the depth step builds BEiT's relative-position biases through
  ``models.frozen_cache``: one a block on its first step at a grid, none
  on the next.
* ``collect()`` is idempotent, the cap counts what it drops.
* Each span counter is registered by the module that owns it
  and reads that module's counter; ``utils.profiling`` imports nothing of
  the port.
* Each reader in ``benchmark/metrics/`` that reads spans, loaded by path as
  the harness loads it, computes its value from a hand-built span list and
  returns None without a step, with a step that lacks its span, with a
  dropped span, or from a program that has no spans (the kernels' launch
  readers also from spans without their counter, or with a step that
  launched the kernel no time, as every step on the CPU; the host-sync
  readers from spans without ``host_syncs``, while a step without a wait
  reads 0); and the spans it names are the ones the tiny steps emit.
  ``profile_eval.spans_ms`` keys the eval steps' spans by path.
"""

import ast
import importlib
import importlib.util
import threading
import time
import tracemalloc
from pathlib import Path

import pytest
import torch

from depthg_tpu_torch import generate_depth as tgen
from depthg_tpu_torch import inference as tinf
from depthg_tpu_torch.models import featurizer as tfeat
from depthg_tpu_torch.models import frozen_cache
from depthg_tpu_torch.models import depth_anything_v2 as tdav2
from depthg_tpu_torch.models import vit as tvit
from depthg_tpu_torch.models.zoedepth import beit as tbeit
from depthg_tpu_torch.models.zoedepth import dpt as tdpt
from depthg_tpu_torch.models.zoedepth import model as tzoe
from depthg_tpu_torch.ops import attention
from depthg_tpu_torch.train import losses as tloss
from depthg_tpu_torch.train import step as tstep
from depthg_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EVAL_VIT = dict(embed_dim=128, depth=2, num_heads=2, patch_size=8)
# a tiny DINOv2 (registers, LayerScale, SwiGLU) at 56 px: a 4 x 4 grid
DINOV2_VIT = dict(patch_size=14, embed_dim=64, depth=3, num_heads=4, img_size=70, n_registers=2,
                  layer_scale=True, ffn="swiglu", pos_resize="dinov2")
TRAIN_VIT = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, img_size=32)
LOSS = dict(feature_samples=3, neg_samples=2, depth_sampling="fps",
            depth_feat_correlation_loss=True)
# a 64 x 96 image: padded to 96 x 136, prepped to 64 x 96, a 4 x 6 grid
# against the 6 x 6 pretraining window
# each span counter: its module, the object that holds it and its attribute
COUNTERS = {
    "k1_launches": ("depthg_tpu_torch.ops.attention", "KERNEL", "launches"),
    "crf_cache_launches": ("depthg_tpu_torch.ops.crf_bilateral", "KERNEL", "cache_launches"),
    "crf_message_launches": ("depthg_tpu_torch.ops.crf_bilateral", "KERNEL", "message_launches"),
    "bins_tail_launches": ("depthg_tpu_torch.ops.zoe_bins", "KERNEL", "bins_launches"),
    "swiglu_gate_launches": ("depthg_tpu_torch.ops.swiglu", "KERNEL", "gate_launches"),
    "residual_norm_launches": ("depthg_tpu_torch.ops.residual_norm", "KERNEL", "launches"),
    "host_syncs": ("depthg_tpu_torch.utils.profiling", "SYNCS", "count"),
    "frozen_cache_builds": ("depthg_tpu_torch.models.frozen_cache", "COUNTS", "builds"),
    "frozen_cache_hits": ("depthg_tpu_torch.models.frozen_cache", "COUNTS", "hits"),
}
ZOE = tzoe.ZoeConfig(n_bins=8, bin_embedding_dim=16, n_attractors=(4, 2, 2, 1),
                     img_size=(64, 96),
                     beit=tbeit.BEiTConfig(embed_dim=64, depth=4, num_heads=4, pretrain_window=6,
                                           hooks=(0, 1, 2, 3)),
                     dpt=tdpt.DPTConfig(embed_dim=64, features=16,
                                        reassemble_channels=(8, 16, 32, 32)))


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def eval_call(predict=False, **kw):
    fcfg = tfeat.FeaturizerConfig(vit_config=tvit.ViTConfig(**EVAL_VIT), dim=16)
    model = tinf.Segmenter(fcfg, 5, 7).init_weights(torch.Generator().manual_seed(0))
    ecfg = tinf.EvalConfig(n_classes=5, extra_clusters=2, label_res=64, **kw)
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(2, 3, 64, 64, generator=gen)
    if predict:
        step = tinf.make_predict_step(ecfg)
        return lambda: step(model, img)
    label = torch.randint(-1, 5, (2, 64, 64), generator=gen)
    step = tinf.make_eval_step(ecfg)
    return lambda: step(model, img, label)


def dinov2_eval_call():
    fcfg = tfeat.FeaturizerConfig(vit_config=tvit.ViTConfig(**DINOV2_VIT), dim=16)
    model = tinf.Segmenter(fcfg, 5, 7).init_weights(torch.Generator().manual_seed(0))
    ecfg = tinf.EvalConfig(n_classes=5, extra_clusters=2, label_res=56, fused_tta=True)
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(2, 3, 56, 56, generator=gen)
    label = torch.randint(-1, 5, (2, 56, 56), generator=gen)
    step = tinf.make_eval_step(ecfg)
    return lambda: step(model, img, label)


def train_call(**kw):
    fcfg = tfeat.FeaturizerConfig(arch="vit_small", patch_size=8, dim=16,
                                  vit_config=tvit.ViTConfig(**TRAIN_VIT), dropout=False,
                                  drop_rate=0.0)
    hp = tstep.TrainHParams(n_classes=3, **kw)
    state = tstep.init_state(fcfg, hp, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"img": torch.randn(8, 3, 32, 32, generator=gen),
             "img_pos": torch.randn(8, 3, 32, 32, generator=gen),
             "label": torch.randint(-1, 3, (8, 32, 32), generator=gen),
             "depth": torch.rand(8, 1, 32, 32, generator=gen),
             "depth_pos": torch.rand(8, 1, 32, 32, generator=gen)}
    lcfg = tloss.CorrLossConfig(**LOSS)
    return lambda: tstep.train_step(state, batch, hp, lcfg, 0.19, 0.03, generator=gen)


def depth_call():
    args = tgen.get_args_parser().parse_args(["--allow_random", "--dtype", "float32"])
    infer, _ = tgen.build(args, torch.device("cpu"), zoe_config=ZOE)
    img = torch.rand(2, 3, 64, 96, generator=torch.Generator().manual_seed(1))
    return lambda: infer(img)


def dav2_call():
    """A Depth Anything V2 of 2 blocks 64 wide on a 56 x 98 image (a 4 x 7
    grid), hooks (0, 0, 1, 1)."""
    vit = tvit.ViTConfig(patch_size=14, embed_dim=64, depth=2, num_heads=4, img_size=70,
                         layer_scale=True)
    cfg = tdav2.DepthAnythingV2Config(vit=vit, hooks=(0, 0, 1, 1), features=16,
                                      out_channels=(8, 16, 32, 32))
    args = tgen.get_args_parser().parse_args(["--model", "depth_anything_v2", "--allow_random",
                                              "--dtype", "float32"])
    infer, _ = tgen.build(args, torch.device("cpu"), dav2_config=cfg)
    img = torch.rand(2, 3, 56, 98, generator=torch.Generator().manual_seed(1))
    return lambda: infer(img)


def tree(spans):
    """The spans as nested (name, [children]) tuples, in the order they opened."""
    kids = {s["id"]: [] for s in spans}
    roots = []
    for s in spans:
        (roots if s["parent"] is None else kids[s["parent"]]).append(s)

    def node(s):
        return (s["name"], [node(k) for k in kids[s["id"]]])
    return [node(s) for s in roots]


def raising(*args, **kwargs):
    raise AssertionError("called while recording is off")


def fake_counter(monkeypatch, name, read):
    """Register ``read`` as the span counter ``name`` for one test."""
    monkeypatch.setattr(profiling, "_COUNTERS", profiling._COUNTERS)
    profiling.register_counter(name, read)


@pytest.mark.parametrize("make", [eval_call, dinov2_eval_call, train_call, depth_call, dav2_call],
                         ids=["eval", "eval-dinov2", "train", "depth", "depth-dav2"])
def test_off_is_inert(monkeypatch, make):
    call = make()
    monkeypatch.setattr(torch.cuda, "Event", raising)
    monkeypatch.setattr(torch.profiler, "record_function", raising)
    for name in COUNTERS:
        fake_counter(monkeypatch, name, raising)
    call()
    assert profiling.span("a") is profiling.span("b")
    assert profiling.collect() == {"spans": [], "dropped": 0}


def test_off_span_allocates_nothing():
    here = tracemalloc.Filter(True, profiling.__file__)
    for _ in range(10):  # warm
        with profiling.span("x"):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot().filter_traces([here])
        for _ in range(1000):
            with profiling.span("x"):
                pass
        after = tracemalloc.take_snapshot().filter_traces([here])
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "lineno") if d.size_diff > 0]
    assert grown == []


def test_off_host_sync_allocates_nothing(monkeypatch):
    """Off, ``host_sync`` is the shared null context and one add to the
    count: it reads no counter, makes no CUDA event and allocates nothing."""
    monkeypatch.setattr(torch.cuda, "Event", raising)
    fake_counter(monkeypatch, "host_syncs", raising)
    here = tracemalloc.Filter(True, profiling.__file__)
    assert profiling.host_sync() is profiling.span("x")
    # past the cached small ints: each add replaces the count's int object
    monkeypatch.setattr(profiling.SYNCS, "count", 1000)
    tracemalloc.start()
    try:
        for _ in range(10):  # warm: the count's int object is traced from here
            with profiling.host_sync():
                pass
        before = tracemalloc.take_snapshot().filter_traces([here])
        for _ in range(1000):
            with profiling.host_sync():
                pass
        after = tracemalloc.take_snapshot().filter_traces([here])
    finally:
        tracemalloc.stop()
    assert profiling.SYNCS.count == 1000 + 10 + 1000
    assert [d for d in after.compare_to(before, "lineno") if d.size_diff > 0] == []
    assert profiling.collect() == {"spans": [], "dropped": 0}


def test_host_sync_counts_in_every_enclosing_span():
    """Each ``host_sync`` is one on ``host_syncs`` in every span open around
    it; the ``host_sync`` span itself opens after the count and reads 0."""
    with profiling.recording():
        with profiling.span("step"):
            with profiling.host_sync():
                pass
            with profiling.span("inner"):
                with profiling.host_sync():
                    pass
    step, first, inner, second = profiling.collect()["spans"]
    assert [s["name"] for s in (first, second)] == ["host_sync"] * 2
    assert first["parent"] == step["id"] and second["parent"] == inner["id"]
    assert (step["host_syncs"], inner["host_syncs"]) == (2, 1)
    assert first["host_syncs"] == second["host_syncs"] == 0


@pytest.mark.parametrize("make, want", [
    (lambda: eval_call(fused_tta=True), 7), (lambda: eval_call(fused_tta=False), 7),
    (dinov2_eval_call, 7), (train_call, 1), (lambda: train_call(fused_pair_forward=True), 1),
    (depth_call, 0), (dav2_call, 0),
], ids=["eval-fused-tta", "eval-two-passes", "eval-dinov2", "train", "train-fused-pair",
        "depth", "depth-dav2"])
def test_steps_count_their_host_syncs(make, want):
    """Each step span carries its ``host_sync`` calls, counted on the CPU too
    (where they wait for nothing): the eval step's 3 + 2 + 2 (see
    ``test_steps_emit_their_span_trees``), the train step's FPS copy, none
    in a depth step."""
    call = make()
    with profiling.recording():
        call()
        call()
    spans = profiling.collect()["spans"]
    steps = [s for s in spans if s["parent"] is None]
    assert len(steps) == 2 and [s["host_syncs"] for s in steps] == [want, want]
    assert sum(s["name"] == "host_sync" for s in spans) == 2 * want


def test_nesting_parent_step_and_self_time():
    with profiling.recording():
        for _ in range(2):
            with profiling.span("outer"):
                with profiling.span("a"):
                    with profiling.span("leaf"):
                        time.sleep(0.002)
                with profiling.span("b"):
                    time.sleep(0.001)
                time.sleep(0.001)
        done = threading.Event()

        def other():
            with profiling.span("thread"):
                done.set()
        with profiling.span("open"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and done.is_set()
    spans = profiling.collect()["spans"]
    by = {}
    for s in spans:
        by.setdefault(s["name"], []).append(s)
    assert tree([s for s in spans if s["name"] not in ("open", "thread")]) == [
        ("outer", [("a", [("leaf", [])]), ("b", [])])] * 2
    # a span in another thread does not nest under this thread's open span
    assert by["thread"][0]["parent"] is None and by["open"][0]["parent"] is None
    for i, outer in enumerate(by["outer"]):
        a, leaf, b = by["a"][i], by["leaf"][i], by["b"][i]
        assert {a["step"], leaf["step"], b["step"], outer["step"]} == {outer["id"]}
        assert a["parent"] == b["parent"] == outer["id"] and leaf["parent"] == a["id"]
        assert outer["self_host_ms"] == pytest.approx(
            outer["host_ms"] - a["host_ms"] - b["host_ms"])
        assert a["self_host_ms"] == pytest.approx(a["host_ms"] - leaf["host_ms"])
        assert leaf["self_host_ms"] == leaf["host_ms"] >= 2.0
        assert outer["self_host_ms"] >= 1.0
        assert outer["host_start_ns"] <= a["host_start_ns"] <= leaf["host_start_ns"] \
            < leaf["host_end_ns"] <= a["host_end_ns"] <= b["host_start_ns"] \
            < b["host_end_ns"] <= outer["host_end_ns"]
        assert a["device_ms"] is None and a["device_start_ns"] is None  # no CUDA here
    assert by["outer"][0]["step"] != by["outer"][1]["step"]


def test_counter_deltas_are_the_kernels_launches():
    k1 = attention.KERNEL
    with profiling.recording():
        k1_0 = k1.launches
        with profiling.span("step"):
            k1.count(False, True)
            with profiling.span("inner"):
                for _ in range(3):
                    k1.count(False, True)
            k1.count(True, False)
        k1_1 = k1.launches
    step, inner = profiling.collect()["spans"]
    assert step["k1_launches"] == k1_1 - k1_0 == 5
    assert inner["k1_launches"] == 3


@pytest.mark.parametrize("name, module, counter, attr", [
    (name, *where) for name, where in COUNTERS.items()])
def test_each_counter_is_registered_by_its_module(monkeypatch, name, module, counter, attr):
    """Each span counter reads its module's own counter as it stands."""
    owner = getattr(importlib.import_module(module), counter)
    monkeypatch.setattr(owner, attr, 41)
    assert profiling._COUNTERS[name]() == 41


def test_profiling_imports_nothing_of_the_port():
    """``utils.profiling`` is a leaf: the modules register their counters."""
    names = []
    for node in ast.walk(ast.parse(Path(profiling.__file__).read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert "torch" in names
    assert not [n for n in names if n.startswith((".", "depthg_tpu_torch"))]


def test_crf_cache_counter_deltas(monkeypatch):
    """``crf_cache_launches`` is the delta of the cache kernel's counter
    (stubbed here: the CPU builds its cache without the kernel) across each
    span."""
    count = iter([10, 11, 14, 16])  # step opens, inner opens, inner closes, step closes
    fake_counter(monkeypatch, "crf_cache_launches", lambda: next(count))
    with profiling.recording():
        with profiling.span("step"):
            with profiling.span("inner"):
                pass
    step, inner = profiling.collect()["spans"]
    assert step["crf_cache_launches"] == 6 and inner["crf_cache_launches"] == 3


def test_stamps_bracket_profiler_events():
    """Under a running profiler, without ``recording()``: the span's
    ``time.time_ns()`` stamps bracket an operator recorded inside it."""
    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            time.sleep(0.001)
            torch.mm(x, x)
            time.sleep(0.001)
    (s,) = profiling.collect()["spans"]
    mm = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "aten::mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert s["host_start_ns"] < start < end < s["host_end_ns"]
    with profiling.span("after"):  # the profiler has stopped: off again
        pass
    assert len(profiling.collect()["spans"]) == 1


# the waits of the eval step: the resize matrices' three copies to the
# device (``ops.resize.resized_sq_norm``), the CRF guidance's two statistics
# (``inference.unnormalize_255``), one bincount a confusion block; its two
# ``confusion`` spans: the argmaxes, then the blocks
SYNC = ("host_sync", [])
LOGITS_SYNCS, CRF_SYNCS = [SYNC] * 3, [SYNC] * 2
CONFUSION = [("confusion", []), ("confusion", [SYNC] * 2)]


@pytest.mark.parametrize("make, want", [
    (lambda: eval_call(fused_tta=True),
     [("eval.step", [("logits", [("backbone", [])] + LOGITS_SYNCS), ("crf", CRF_SYNCS)]
      + CONFUSION)]),
    (lambda: eval_call(fused_tta=False),
     [("eval.step", [("logits", [("backbone", [])] * 2 + LOGITS_SYNCS), ("crf", CRF_SYNCS)]
      + CONFUSION)]),
    (lambda: eval_call(predict=True, fused_tta=True),
     [("logits", [("backbone", [])] + LOGITS_SYNCS), ("crf", CRF_SYNCS)]),
    # the depth-guided FPS's one copy to the device (``ops.depth``)
    (lambda: train_call(),
     [("train.step", [("optimizer", []),
                      ("train.forward", [("backbone", []), ("backbone", []), SYNC]),
                      ("backward", []), ("optimizer", [])])]),
    (lambda: train_call(fused_pair_forward=True),
     [("train.step", [("optimizer", []), ("train.forward", [("backbone", []), SYNC]),
                      ("backward", []), ("optimizer", [])])]),
    (depth_call,
     [("depth.step", [("backbone", []), ("dpt", []), ("bins", [])] * 2)]),
    (dinov2_eval_call,
     [("eval.step", [("logits", [("backbone", [("swiglu", [])] * DINOV2_VIT["depth"])]
                      + LOGITS_SYNCS), ("crf", CRF_SYNCS)] + CONFUSION)]),
    (dav2_call, [("depth.step", [("backbone", []), ("dpt", []), ("out_head", [])])]),
], ids=["eval-fused-tta", "eval-two-passes", "predict", "train", "train-fused-pair", "depth",
        "eval-dinov2", "depth-dav2"])
def test_steps_emit_their_span_trees(make, want):
    call = make()
    with profiling.recording():
        call()
        call()
    got = profiling.collect()
    assert got["dropped"] == 0
    assert tree(got["spans"]) == want * 2
    for s in got["spans"]:
        assert s["self_host_ms"] >= 0 and s["k1_launches"] == 0


def test_rel_bias_builds_once_a_grid():
    """The first depth step at a grid builds one bias a block
    (``models.frozen_cache``'s builds), in its first pass's ``backbone``
    span; the flip pass and the next step build none and take each block's
    bias from its table's cache (hits)."""
    call = depth_call()
    before = frozen_cache.COUNTS.builds
    with profiling.recording():
        call()
        call()
    spans = profiling.collect()["spans"]
    steps = [s for s in spans if s["name"] == "depth.step"]
    assert [(s["frozen_cache_builds"], s["frozen_cache_hits"]) for s in steps] == \
        [(ZOE.beit.depth, ZOE.beit.depth), (0, 2 * ZOE.beit.depth)]
    assert frozen_cache.COUNTS.builds - before == ZOE.beit.depth
    first = [(s["frozen_cache_builds"], s["frozen_cache_hits"]) for s in spans
             if s["step"] == steps[0]["id"] and s["name"] == "backbone"]
    assert first == [(ZOE.beit.depth, 0), (0, ZOE.beit.depth)]
    assert all(s["frozen_cache_builds"] == s["frozen_cache_hits"] == 0 for s in spans
               if s["name"] in ("dpt", "bins"))


def test_collect_is_idempotent_and_clear_empties():
    with profiling.recording():
        with profiling.span("a"):
            pass
    first = profiling.collect()
    assert profiling.collect() == first and len(first["spans"]) == 1
    with profiling.recording():
        with profiling.span("b"):
            pass
    second = profiling.collect()
    assert [s["name"] for s in second["spans"]] == ["a", "b"]
    assert second["spans"][0] == first["spans"][0]
    assert [s["name"] for s in first["spans"]] == ["a"]  # the old result is left as it was
    profiling.clear()
    assert profiling.collect() == {"spans": [], "dropped": 0}


def test_cap_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    rec = profiling.Recorder()
    with rec.recording():
        for i in range(5):
            with rec.span(f"s{i}"):
                pass
    got = rec.collect()
    assert [s["name"] for s in got["spans"]] == ["s0", "s1", "s2"] and got["dropped"] == 2
    rec.clear()
    assert rec.collect() == {"spans": [], "dropped": 0}


def span(id, name, parent=None, step=None, host=1.0, self_host=None, device=None, k1=0,
         cache=0, bins=0, message=0, gate=0, syncs=0, junction=0):
    return {"id": id, "name": name, "parent": parent, "step": id if step is None else step,
            "host_ms": host, "self_host_ms": host if self_host is None else self_host,
            "device_ms": device, "k1_launches": k1, "crf_cache_launches": cache,
            "bins_tail_launches": bins, "crf_message_launches": message,
            "swiglu_gate_launches": gate, "host_syncs": syncs,
            "residual_norm_launches": junction}


def eval_spans(device=True):
    """Two eval steps (one with two passes) and the spans of a predict step,
    which has no step span of its own; the ``logits`` and ``confusion``
    spans come last (ids 10-16: a step's blocks, then its argmaxes), each
    ``backbone`` inside a ``logits``."""
    d = (lambda v: v) if device else (lambda v: None)
    return [span(1, "eval.step", host=50.0, device=d(70.0), k1=12, cache=1, message=13,
                 syncs=7, junction=37),
            span(2, "backbone", 10, 1, host=5.0, device=d(20.0)),
            span(3, "crf", 1, 1, host=30.0, device=d(44.0), cache=1, message=13, syncs=2),
            span(4, "eval.step", host=52.0, device=d(74.0), k1=12, cache=1, message=11,
                 syncs=7, junction=37),
            span(5, "backbone", 11, 4, host=3.0, device=d(11.0)),
            span(6, "backbone", 11, 4, host=3.0, device=d(11.0)),
            span(7, "crf", 4, 4, host=31.0, device=d(46.0), cache=1, message=11, syncs=2),
            span(8, "backbone", 14, 14, host=5.0, device=d(99.0), k1=12),
            span(9, "crf", host=30.0, device=d(99.0), cache=1, message=13, syncs=2),
            span(10, "logits", 1, 1, host=8.0, device=d(24.0), syncs=3),
            span(11, "logits", 4, 4, host=9.0, device=d(27.0), syncs=3),
            span(12, "confusion", 1, 1, host=2.0, device=d(2.0), syncs=2),
            span(13, "confusion", 4, 4, host=2.0, device=d(3.0), syncs=2),
            span(14, "logits", host=8.0, device=d(99.0), syncs=3),
            span(15, "confusion", 1, 1, host=0.1, device=d(0.4)),
            span(16, "confusion", 4, 4, host=0.1, device=d(0.6))]


def depth_spans(device=True):
    """Two depth steps of two passes each (backbone, dpt, bins a pass)."""
    d = (lambda v: v) if device else (lambda v: None)
    out = []
    for i, base in enumerate((1, 8)):
        out.append(span(base, "depth.step", host=90.0, device=d(85.0), k1=48, bins=2,
                        syncs=i))
        for p in range(2):
            out += [span(base + 1 + 3 * p, "backbone", base, base, device=d(20.0 + i)),
                    span(base + 2 + 3 * p, "dpt", base, base, device=d(9.0)),
                    span(base + 3 + 3 * p, "bins", base, base, device=d(6.0 + p))]
    return out


def dinov2_spans(device=True):
    """Two DINOv2 eval steps: one backbone pass of 3 blocks, one ``swiglu``
    span each (the steps' launch counts those of ViT-g's 40 blocks), inside
    a ``logits`` span (ids 20-21), then ``crf`` and ``confusion`` (22-23)."""
    d = (lambda v: v) if device else (lambda v: None)
    out = []
    for i, base in enumerate((1, 7)):
        out += [span(base, "eval.step", host=200.0, device=d(250.0), k1=40, cache=1, message=13,
                     gate=40, syncs=7, junction=121),
                span(base + 1, "backbone", 20 + i, base, host=20.0, device=d(160.0 + i))]
        out += [span(base + 2 + k, "swiglu", base + 1, base, host=1.0, device=d(30.0 + k + i),
                     gate=1) for k in range(3)]
        out.append(span(base + 5, "crf", base, base, host=30.0, device=d(60.0),
                        cache=1, message=13, syncs=2))
    for i, base in enumerate((1, 7)):
        out += [span(20 + i, "logits", base, base, host=25.0, device=d(190.0 + 2 * i), syncs=3),
                span(22 + i, "confusion", base, base, host=3.0, device=d(6.0 + i), syncs=2)]
    return out


def dav2_spans(device=True):
    """Two Depth Anything V2 depth steps of one pass each."""
    d = (lambda v: v) if device else (lambda v: None)
    out = []
    for i, base in enumerate((1, 5)):
        out += [span(base, "depth.step", host=60.0, device=d(58.0), k1=24, junction=76),
                span(base + 1, "backbone", base, base, device=d(33.0 + i)),
                span(base + 2, "dpt", base, base, device=d(17.0)),
                span(base + 3, "out_head", base, base, device=d(6.0 + 2 * i))]
    return out


def train_spans():
    out = []
    for i, base in enumerate((1, 8)):
        out += [span(base, "train.step", host=44.0, k1=24, syncs=1 + 2 * i),
                span(base + 1, "optimizer", base, base, host=0.2),
                span(base + 2, "train.forward", base, base, host=30.0, self_host=14.0 + i),
                span(base + 3, "backbone", base + 2, base, host=8.0 + i),
                span(base + 4, "backbone", base + 2, base, host=8.0),
                span(base + 5, "backward", base, base, host=9.0 + 2 * i),
                span(base + 6, "optimizer", base, base, host=2.0)]
    return out


READERS = {
    "backbone_device_ms.eval": (eval_spans, (20.0 + 22.0) / 2),
    "k1_launches_per_step.eval": (eval_spans, 12.0),
    "crf_cache_launches_per_step.eval": (eval_spans, 1.0),
    "crf_message_launches_per_step.eval": (eval_spans, 12.0),
    "backbone_host_ms.train": (train_spans, (16.0 + 17.0) / 2),
    "losses_host_ms.train": (train_spans, (14.0 + 15.0) / 2),
    "backward_host_ms.train": (train_spans, (9.0 + 11.0) / 2),
    "optimizer_host_ms.train": (train_spans, 2.2),
    "k1_launches_per_step.train": (train_spans, 24.0),
    "backbone_device_ms.depth": (depth_spans, (40.0 + 42.0) / 2),
    "dpt_device_ms.depth": (depth_spans, 18.0),
    "bins_device_ms.depth": (depth_spans, 13.0),
    "k1_launches_per_step.depth": (depth_spans, 48.0),
    "bins_tail_launches_per_step.depth": (depth_spans, 2.0),
    "swiglu_device_ms.eval_dinov2": (dinov2_spans, (93.0 + 96.0) / 2),
    "swiglu_gate_launches_per_step.eval_dinov2": (dinov2_spans, 40.0),
    "out_head_device_ms.depth_dav2": (dav2_spans, 7.0),
    "host_syncs_per_step.eval": (eval_spans, 7.0),
    "host_syncs_per_step.train": (train_spans, 2.0),
    "host_syncs_per_step.depth": (depth_spans, 0.5),
    "logits_device_ms.eval": (eval_spans, (4.0 + 5.0) / 2),
    "confusion_device_ms.eval": (eval_spans, (2.4 + 3.6) / 2),
    "residual_norm_launches_per_step.eval": (eval_spans, 37.0),
    "residual_norm_launches_per_step.depth_dav2": (dav2_spans, 76.0),
}

# the eval readers that read the DINOv2 cell too, on its step's spans
DINOV2_READS = {
    "backbone_device_ms.eval": (160.0 + 161.0) / 2,
    "k1_launches_per_step.eval": 40.0,
    "crf_cache_launches_per_step.eval": 1.0,
    "crf_message_launches_per_step.eval": 13.0,
    "host_syncs_per_step.eval": 7.0,
    "logits_device_ms.eval": (30.0 + 31.0) / 2,
    "confusion_device_ms.eval": 6.5,
    "residual_norm_launches_per_step.eval": 121.0,
}
# the depth readers that read the Depth Anything V2 cell too, on its step's spans
DAV2_READS = {
    "backbone_device_ms.depth": (33.0 + 34.0) / 2,
    "dpt_device_ms.depth": 17.0,
    "k1_launches_per_step.depth": 24.0,
    "host_syncs_per_step.depth": 0.0,  # a step without a wait reads 0
}
SPAN_CASES = [pytest.param(name, make, want, id=name) for name, (make, want) in READERS.items()] \
    + [pytest.param(name, dinov2_spans, want, id=name + "-dinov2")
       for name, want in DINOV2_READS.items()] \
    + [pytest.param(name, dav2_spans, want, id=name + "-dav2")
       for name, want in DAV2_READS.items()]


def load_reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_readers_are_the_span_metrics_of_the_benchmark():
    """Every per-layer metric whose reader reads spans is tested here."""
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    span_readers = {m["name"] for m in bench["per_layer"]
                    if "benchmark.spans" in (ROOT / "benchmark" / "metrics"
                                             / f"{m['name']}.py").read_text()}
    assert span_readers == set(READERS)


@pytest.mark.parametrize("name,make,want", SPAN_CASES)
def test_span_readers(monkeypatch, name, make, want):
    reader = load_reader(name)

    def read(spans, dropped=0):
        monkeypatch.setattr(profiling, "collect", lambda: {"spans": spans, "dropped": dropped})
        return reader.read({}, {})

    assert read(make()) == pytest.approx(want)
    assert read([]) is None
    other = train_spans if make in (eval_spans, dinov2_spans) else eval_spans
    assert read(other()) is None  # no step of its kind
    assert read(make(), dropped=1) is None
    if reader.SPAN != reader.STEP:  # a step whose span is gone (renamed, moved) reads nothing
        first = make()[0]["id"]
        assert read([s for s in make()
                     if not (s["name"] == reader.SPAN and s["step"] == first)]) is None
    if reader.KEY == "device_ms":
        assert read(make(device=False)) is None  # recorded without CUDA
    monkeypatch.delattr(profiling, "collect")  # a program without spans
    assert reader.read({}, {}) is None


@pytest.mark.parametrize("case", ["without_the_counter", "a_step_without_a_launch"])
def test_cache_reader_reads_nothing_without_the_kernel(monkeypatch, case):
    """Spans of a program whose steps do not carry ``crf_cache_launches``,
    or where an eval step launched the cache kernel no time (its cache built
    without the kernel), read nothing, and raise nothing: losing the kernel
    never reads as fewer launches."""
    spans = eval_spans()
    for s in spans:
        if case == "without_the_counter":
            del s["crf_cache_launches"]
        elif s["id"] == 4:
            s["crf_cache_launches"] = 0
    monkeypatch.setattr(profiling, "collect", lambda: {"spans": spans, "dropped": 0})
    assert load_reader("crf_cache_launches_per_step.eval").read({}, {}) is None
    assert load_reader("k1_launches_per_step.eval").read({}, {}) == 12.0


@pytest.mark.parametrize("case", ["without_the_counter", "a_step_without_a_launch"])
def test_message_reader_reads_nothing_without_the_kernel(monkeypatch, case):
    """Spans of a program whose steps do not carry ``crf_message_launches``
    (the parent of the int8 message kernel), or where an eval step launched
    it no time (its messages run without the kernel), read nothing, and
    raise nothing: losing the kernel never reads as fewer launches."""
    spans = eval_spans()
    for s in spans:
        if case == "without_the_counter":
            del s["crf_message_launches"]
        elif s["id"] == 4:
            s["crf_message_launches"] = 0
    monkeypatch.setattr(profiling, "collect", lambda: {"spans": spans, "dropped": 0})
    assert load_reader("crf_message_launches_per_step.eval").read({}, {}) is None
    assert load_reader("crf_cache_launches_per_step.eval").read({}, {}) == 1.0


def test_crf_message_counter_deltas(monkeypatch):
    """``crf_message_launches`` is the delta of the message kernel's counter
    (stubbed here: the CPU runs its messages without the kernel) across each
    span."""
    count = iter([100, 101, 112, 113])  # step opens, inner opens, inner closes, step closes
    fake_counter(monkeypatch, "crf_message_launches", lambda: next(count))
    with profiling.recording():
        with profiling.span("step"):
            with profiling.span("inner"):
                pass
    step, inner = profiling.collect()["spans"]
    assert step["crf_message_launches"] == 13 and inner["crf_message_launches"] == 11


@pytest.mark.parametrize("case", ["without_the_counter", "a_step_without_a_launch"])
def test_bins_tail_reader_reads_nothing_without_the_kernel(monkeypatch, case):
    """Spans of a program whose steps do not carry ``bins_tail_launches``,
    or where a depth step launched the bins tail kernel no time (its tail
    run by the module's code), read nothing, and raise nothing: losing the
    kernel never reads as fewer launches."""
    spans = depth_spans()
    for s in spans:
        if case == "without_the_counter":
            del s["bins_tail_launches"]
        elif s["id"] == 8:
            s["bins_tail_launches"] = 0
    monkeypatch.setattr(profiling, "collect", lambda: {"spans": spans, "dropped": 0})
    assert load_reader("bins_tail_launches_per_step.depth").read({}, {}) is None
    assert load_reader("k1_launches_per_step.depth").read({}, {}) == 48.0


def test_depth_spans_carry_the_bins_tail_launches():
    """Every span of the depth step carries the bins tail kernel's launches,
    0 on the CPU (the module's code runs the tail there)."""
    call = depth_call()
    with profiling.recording():
        call()
        call()
    spans = profiling.collect()["spans"]
    assert len(spans) == 14
    assert all(s["bins_tail_launches"] == 0 for s in spans)


STEP_CASES = [pytest.param(name, name.rsplit(".", 1)[1], id=name) for name in sorted(READERS)] \
    + [pytest.param(name, "eval_dinov2", id=name + "-dinov2") for name in sorted(DINOV2_READS)] \
    + [pytest.param(name, "depth_dav2", id=name + "-dav2") for name in sorted(DAV2_READS)]


@pytest.mark.parametrize("name,kind", STEP_CASES)
def test_readers_name_the_spans_the_steps_emit(name, kind):
    """Each reader's step and span, as the tiny step of each cell kind it
    reads emits them: every step holds the span, and the reader reads a
    number (a stream time only where CUDA runs)."""
    from benchmark.spans import per_step

    reader = load_reader(name)
    call = {"eval": lambda: eval_call(fused_tta=True), "train": train_call,
            "depth": depth_call, "eval_dinov2": dinov2_eval_call,
            "depth_dav2": dav2_call}[kind]()
    with profiling.recording():
        call()
        call()
    got = profiling.collect()
    assert sum(s["name"] == reader.STEP and s["parent"] is None for s in got["spans"]) == 2
    assert per_step(reader.STEP, reader.SPAN, "host_ms") > 0
    value = reader.read({}, {})
    if reader.KEY == "device_ms":
        assert value is None  # no CUDA here
    elif reader.KEY in ("crf_cache_launches", "crf_message_launches"):
        assert value is None  # the CPU builds its cache and messages without the kernels
        assert per_step(reader.STEP, reader.SPAN, reader.KEY) == 0
    elif reader.KEY == "bins_tail_launches":
        assert value is None  # the CPU runs the bins tail without the kernel
        assert per_step(reader.STEP, reader.SPAN, reader.KEY) == 0
    elif reader.KEY == "swiglu_gate_launches":
        assert value is None  # the CPU runs the SwiGLU gate without the kernel
        assert per_step(reader.STEP, reader.SPAN, reader.KEY) == 0
    elif reader.KEY == "residual_norm_launches":
        assert value is None  # the CPU runs the blocks' junctions without the kernel
        assert per_step(reader.STEP, reader.SPAN, reader.KEY) == 0
    else:
        assert value is not None and value >= 0


HOST_SYNC_READERS = {"host_syncs_per_step.eval": eval_spans,
                     "host_syncs_per_step.train": train_spans,
                     "host_syncs_per_step.depth": depth_spans}


@pytest.mark.parametrize("name", sorted(HOST_SYNC_READERS))
@pytest.mark.parametrize("case", ["without_the_counter", "steps_without_a_wait"])
def test_host_sync_readers_read_zero_but_not_without_the_counter(monkeypatch, name, case):
    """Steps without a ``host_sync`` read 0, a reading; spans of a program
    whose spans do not carry ``host_syncs`` (the parent of the counter)
    read nothing, and raise nothing."""
    spans = HOST_SYNC_READERS[name]()
    for s in spans:
        if case == "without_the_counter":
            del s["host_syncs"]
        else:
            s["host_syncs"] = 0
    monkeypatch.setattr(profiling, "collect", lambda: {"spans": spans, "dropped": 0})
    got = load_reader(name).read({}, {})
    assert got is None if case == "without_the_counter" else got == 0.0


def test_logits_reader_reads_nothing_without_a_backbone_inside(monkeypatch):
    """A step whose ``logits`` span holds no ``backbone`` span (a backbone
    moved out of it, or renamed) reads nothing: its logits would count the
    backbone's time."""
    spans = eval_spans()
    for s in spans:
        if s["name"] == "backbone" and s["step"] == 4:
            s["parent"] = 4
    monkeypatch.setattr(profiling, "collect", lambda: {"spans": spans, "dropped": 0})
    assert load_reader("logits_device_ms.eval").read({}, {}) is None
    assert load_reader("backbone_device_ms.eval").read({}, {}) == pytest.approx(21.0)


def test_profile_eval_splits_the_eval_steps_by_span_path():
    """``profile_eval.spans_ms``: each span under the ``eval.step`` spans,
    keyed by its path, per step; the predict step's spans are left out."""
    from depthg_tpu_torch.profile_eval import spans_ms

    got = spans_ms(eval_spans())
    assert sorted(got) == ["eval.step", "eval.step/confusion", "eval.step/crf",
                           "eval.step/logits", "eval.step/logits/backbone"]
    assert got["eval.step"] == pytest.approx({"host": 51.0, "self_host": 51.0, "device": 72.0})
    assert got["eval.step/logits/backbone"] == pytest.approx(
        {"host": 5.5, "self_host": 5.5, "device": 21.0})
    assert got["eval.step/confusion"] == pytest.approx(  # both spans of a step
        {"host": 2.1, "self_host": 2.1, "device": 3.0})


def test_only_a_swiglu_backbone_opens_swiglu_spans():
    """One ``swiglu`` span per block under each ``backbone`` span of a
    DINOv2 step; a DINO v1 step (GELU ``Mlp``) opens none, and the span
    reader of the SwiGLU reads nothing from its spans."""
    for make, want in ((dinov2_eval_call, DINOV2_VIT["depth"]),
                       (lambda: eval_call(fused_tta=True), 0)):
        call = make()
        profiling.clear()
        with profiling.recording():
            call()
        spans = profiling.collect()["spans"]
        backbone = [s for s in spans if s["name"] == "backbone"]
        assert len(backbone) == 1
        swiglu = [s for s in spans if s["name"] == "swiglu"]
        assert len(swiglu) == want and all(s["parent"] == backbone[0]["id"] for s in swiglu)
    reader = load_reader("swiglu_device_ms.eval_dinov2")
    assert reader.read({}, {}) is None  # the DINO v1 step's spans, recorded last


def test_swiglu_reader_reads_nothing_without_the_span(monkeypatch):
    """Spans of a step whose backbone opens no ``swiglu`` span (DINO v1's,
    or a program without the span) read nothing, and raise nothing."""
    spans = [s for s in dinov2_spans() if s["name"] != "swiglu"]
    monkeypatch.setattr(profiling, "collect", lambda: {"spans": spans, "dropped": 0})
    assert load_reader("swiglu_device_ms.eval_dinov2").read({}, {}) is None
    assert load_reader("backbone_device_ms.eval").read({}, {}) == pytest.approx(160.5)
    monkeypatch.setattr(profiling, "collect", lambda: {"spans": eval_spans(), "dropped": 0})
    assert load_reader("swiglu_device_ms.eval_dinov2").read({}, {}) is None


@pytest.mark.parametrize("case", ["without_the_counter", "a_step_without_a_launch"])
def test_swiglu_gate_reader_reads_nothing_without_the_kernel(monkeypatch, case):
    """Spans of a program whose steps do not carry ``swiglu_gate_launches``
    (the parent of the gate kernel), or where a DINOv2 eval step launched
    it no time (its gate run eagerly), read nothing, and raise nothing:
    losing the kernel never reads as fewer launches."""
    spans = dinov2_spans()
    for s in spans:
        if case == "without_the_counter":
            del s["swiglu_gate_launches"]
        elif s["step"] == 7:
            s["swiglu_gate_launches"] = 0
    monkeypatch.setattr(profiling, "collect", lambda: {"spans": spans, "dropped": 0})
    assert load_reader("swiglu_gate_launches_per_step.eval_dinov2").read({}, {}) is None
    assert load_reader("k1_launches_per_step.eval").read({}, {}) == 40.0
    monkeypatch.setattr(profiling, "collect", lambda: {"spans": eval_spans(), "dropped": 0})
    # a DINO v1 step launches no gate
    assert load_reader("swiglu_gate_launches_per_step.eval_dinov2").read({}, {}) is None


@pytest.mark.parametrize("case", ["without_the_counter", "a_step_without_a_launch"])
@pytest.mark.parametrize("name,make", [
    ("residual_norm_launches_per_step.eval", eval_spans),
    ("residual_norm_launches_per_step.eval", dinov2_spans),
    ("residual_norm_launches_per_step.depth_dav2", dav2_spans)])
def test_residual_norm_readers_read_nothing_without_the_kernel(monkeypatch, name, make, case):
    """Spans of a program whose steps do not carry
    ``residual_norm_launches`` (the parent of the junction kernel), or where
    a step launched it no time (its junctions run eagerly), read nothing, and
    raise nothing: losing the kernel never reads as fewer launches."""
    spans = make()
    first = spans[0]["id"]
    for s in spans:
        if case == "without_the_counter":
            del s["residual_norm_launches"]
        elif s["step"] == first:
            s["residual_norm_launches"] = 0
    monkeypatch.setattr(profiling, "collect", lambda: {"spans": spans, "dropped": 0})
    assert load_reader(name).read({}, {}) is None


def test_dav2_junction_reader_reads_nothing_from_a_zoedepth_step(monkeypatch):
    """ZoeDepth's BEiT keeps its eager junctions: its depth steps launch the
    junction kernel no time, and the Depth Anything V2 reader reads nothing."""
    monkeypatch.setattr(profiling, "collect", lambda: {"spans": depth_spans(), "dropped": 0})
    assert load_reader("residual_norm_launches_per_step.depth_dav2").read({}, {}) is None
    assert load_reader("k1_launches_per_step.depth").read({}, {}) == 48.0


def test_swiglu_gate_counter_deltas(monkeypatch):
    """``swiglu_gate_launches`` is the delta of the gate kernel's counter
    (stubbed here: the CPU runs the gate without the kernel) across each
    span."""
    count = iter([0, 2, 3, 40])  # step opens, inner opens, inner closes, step closes
    fake_counter(monkeypatch, "swiglu_gate_launches", lambda: next(count))
    with profiling.recording():
        with profiling.span("step"):
            with profiling.span("swiglu"):
                pass
    step, inner = profiling.collect()["spans"]
    assert step["swiglu_gate_launches"] == 40 and inner["swiglu_gate_launches"] == 1


def test_dinov2_spans_carry_the_swiglu_gate_launches():
    """Every span of the tiny DINOv2 eval step carries the gate kernel's
    launches, 0 on the CPU (the plain gate runs there)."""
    call = dinov2_eval_call()
    with profiling.recording():
        call()
    spans = profiling.collect()["spans"]
    assert sum(s["name"] == "swiglu" for s in spans) == DINOV2_VIT["depth"]
    assert all(s["swiglu_gate_launches"] == 0 for s in spans)


def test_out_head_reader_reads_nothing_from_a_zoedepth_step(monkeypatch):
    """ZoeDepth's depth step opens no ``out_head`` span (its head is inside
    ``dpt``): the reader reads nothing there, and raises nothing."""
    monkeypatch.setattr(profiling, "collect", lambda: {"spans": depth_spans(), "dropped": 0})
    assert load_reader("out_head_device_ms.depth_dav2").read({}, {}) is None
    assert load_reader("dpt_device_ms.depth").read({}, {}) == pytest.approx(18.0)
