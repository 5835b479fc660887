"""`drivers/eval_dinov2.py` on a tiny spec (`_tiny_dinov2.py`): a sound
run passes; each fault planted in the program, under a run that skips
only the look for a card, turns `correct` false on the number meant to
catch it; `readings` gives every number the limits are set from; the
counts behind `mfu.eval` and `k1_roofline_pct.eval` in the DINOv2 cell at
the published widths.

The program runs in float32 here, so a sound run reads 0 on every number.
The backbone faults are planted at the tiny size's LayerScale of 0.3 (the
configuration's 0.1 moves a 3-block backbone too little to show against
the card's limits)."""

from __future__ import annotations

import time

import pytest
import torch
import torch.nn.functional as F

import depthg_tpu_torch.inference as inference
from benchmark import counting_dinov2
from benchmark.drivers import eval_dinov2 as driver
from benchmark.run import resolve, verdict
from benchmark.tests._tiny_dinov2 import tiny_dinov2_spec, tiny_preset
from depthg_tpu_torch.models import vit

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    tiny_preset(monkeypatch)
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run_cell():
    spec = tiny_dinov2_spec()
    spec["config"]["eval"]["backbone_dtype"] = "float32"
    spec["config"]["init"]["layer_scale"] = 0.3
    out = driver.run(spec, seed=2 ** 31 + 17, seconds=0.3, trace=False, dev=CPU,
                     t_start=time.perf_counter())
    return out


def caught(checks: dict, number: str) -> bool:
    return checks[number][0] > checks[number][1] and not verdict(checks)


def test_sound_run_passes():
    out = run_cell()
    assert out["failed"] == 0 and out["attempted"] > 0
    assert {k: v for k, (v, _) in out["checks"].items()} == \
        {"count_gap": 0, "label_gap": 0.0, "feat_gap": 0.0}
    assert verdict(out["checks"])


def test_registers_left_out(monkeypatch):
    prepare = vit.VisionTransformer.prepare_tokens

    def without(self, x):
        tokens = prepare(self, x)
        return torch.cat([tokens[:, :1], tokens[:, 1 + self.cfg.n_registers:]], dim=1)

    monkeypatch.setattr(vit.VisionTransformer, "prepare_tokens", without)
    monkeypatch.setattr(vit.ViTConfig, "n_prefix", property(lambda self: 1))
    assert caught(run_cell()["checks"], "feat_gap")


def test_layer_scale_left_out(monkeypatch):
    monkeypatch.setattr(vit.LayerScale, "forward", lambda self, x: x)
    assert caught(run_cell()["checks"], "feat_gap")


def test_gate_as_gelu(monkeypatch):
    def gelu_gate(self, x):
        a, b = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.gelu(a) * b)

    monkeypatch.setattr(vit.SwiGLU, "forward", gelu_gate)
    assert caught(run_cell()["checks"], "feat_gap")


def test_half_batch(monkeypatch):
    make = inference.make_eval_step

    def half(ecfg, group=None):
        step = make(ecfg, group)
        return lambda model, img, label: step(model, img[: len(img) // 2],
                                              label[: len(label) // 2])

    monkeypatch.setattr(inference, "make_eval_step", half)
    checks = run_cell()["checks"]
    assert caught(checks, "count_gap")


def test_answer_altered(monkeypatch):
    predictions = inference.predictions

    def altered(model, img, ecfg):
        lin, clu = predictions(model, img, ecfg)
        return torch.cat([(lin[:1] + 1) % ecfg.n_classes, lin[1:]]), clu

    monkeypatch.setattr(inference, "predictions", altered)
    checks = run_cell()["checks"]
    assert caught(checks, "label_gap") and checks["count_gap"][0] == 0


def test_readings_name_every_number():
    spec = tiny_dinov2_spec()
    got = driver.readings(spec, 3, CPU)
    assert set(got["program"]) == {"label_gap", "feat_gap", "count_gap"}
    assert set(got["control"]) == {"label_gap", "feat_gap"}
    assert set(got["faults"]) == {*driver.FAULTS, "half_batch", "answer_altered"}
    assert got["program"]["count_gap"] == 0 and got["faults"]["half_batch"]["count_gap"] > 0
    for name in ("registers_left_out", "layer_scale_left_out", "gate_as_gelu"):
        assert got["faults"][name]["feat_gap"] > got["program"]["feat_gap"]


def test_published_counts():
    cfg = resolve("vitg14reg-eval-b16-448")["config"]
    t, d, h = 1 + 4 + 32 * 32, 1536, 4096
    block = 2 * t * d * (4 * d + 3 * h) + 4 * 24 * t * t * 64
    vit_flops = 40 * block + 2 * 32 * 32 * 3 * 14 * 14 * d
    assert counting_dinov2.vit_flops(cfg["backbone"], 448) == pytest.approx(vit_flops, rel=1e-12)
    step = counting_dinov2.eval_step_flops(cfg, 16)
    assert 83.0e12 < step < 83.3e12  # ~83.1 TFLOP, 60% of it the SwiGLU's
    assert counting_dinov2.swiglu_flops(cfg["backbone"], 448) * 32 / step == \
        pytest.approx(0.598, abs=1e-3)
    ops_s = 4 * 32 * 24 * t * t * 64 / 989e12
    assert ops_s > 4 * 32 * 24 * t * 64 * 2 / 3.35e12  # operations bound this attention
    assert counting_dinov2.eval_attention_bound_s(cfg, 16) == pytest.approx(40 * ops_s,
                                                                           rel=1e-12)
