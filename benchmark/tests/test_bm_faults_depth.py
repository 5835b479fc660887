"""Each fault the depth cell can have, planted in the program under a run
that skips only the look for a card, turns `correct` false, and the number
meant to catch it is the one that fails; a sound run passes.

The program runs in float32 here, so a sound run reads 0 on both numbers.
BEiT is cut to 8 blocks of 256 (16 heads of 16) at LayerScale 1: at the
other tiny sizes the relative-position bias moves the depth too little to
show against the card's limits."""

from __future__ import annotations

import time

import pytest
import torch

import depthg_tpu_torch.models.zoedepth as zoe_pkg
from benchmark.drivers import depth as depth_driver
from benchmark.run import verdict
from benchmark.tests._tiny_depth import tiny_depth_spec
from depthg_tpu_torch.models.zoedepth import beit
from depthg_tpu_torch.models.zoedepth.model import ZoeDepth

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run_cell():
    spec = tiny_depth_spec()
    cfg = spec["config"]
    cfg["infer"]["dtype"] = "float32"
    cfg["init"]["layer_scale"] = 1.0
    cfg["beit"].update(embed_dim=256, num_heads=16, depth=8, hooks=[1, 3, 5, 7])
    out = depth_driver.run(spec, seed=2 ** 31 + 17, seconds=0.3, trace=False, dev=CPU,
                           t_start=time.perf_counter())
    return out


def test_sound_run_passes():
    out = run_cell()
    assert out["failed"] == 0 and out["attempted"] > 0
    assert {k: v for k, (v, _) in out["checks"].items()} == {"depth_gap": 0.0, "png_gap": 0.0}
    assert verdict(out["checks"])


def test_bias_dropped(monkeypatch):
    build = beit.Attention.rel_pos_bias
    monkeypatch.setattr(beit.Attention, "rel_pos_bias",
                        lambda self, h, w: torch.zeros_like(build(self, h, w)))
    checks = run_cell()["checks"]
    assert checks["depth_gap"][0] > checks["depth_gap"][1]
    assert not verdict(checks)


def test_last_attractor_skipped(monkeypatch):
    bins = ZoeDepth._bins

    def skipped(self, *args, **kwargs):  # zip() over the stages stops one short
        every = self.attractors
        self.attractors = every[:-1]
        try:
            return bins(self, *args, **kwargs)
        finally:
            self.attractors = every

    monkeypatch.setattr(ZoeDepth, "_bins", skipped)
    checks = run_cell()["checks"]
    assert checks["depth_gap"][0] > checks["depth_gap"][1]
    assert not verdict(checks)


def _wrap_infer(monkeypatch, change):
    infer = zoe_pkg.zoedepth_infer

    def wrapped(model, x, **kwargs):
        return change(infer, model, x, **kwargs)

    monkeypatch.setattr(zoe_pkg, "zoedepth_infer", wrapped)


def test_flip_left_out(monkeypatch):
    _wrap_infer(monkeypatch, lambda infer, model, x, **kw: infer(model, x, with_flip_aug=False,
                                                                 **kw))
    checks = run_cell()["checks"]
    assert checks["depth_gap"][0] > checks["depth_gap"][1]
    assert not verdict(checks)


def test_half_batch_unwritten(monkeypatch):
    def half(infer, model, x, **kw):
        depth, feats = infer(model, x, **kw)
        return torch.cat([depth[: len(depth) // 2], torch.zeros_like(depth[len(depth) // 2:])]), \
            feats

    _wrap_infer(monkeypatch, half)
    checks = run_cell()["checks"]
    assert checks["depth_gap"][0] > checks["depth_gap"][1]
    assert not verdict(checks)


def test_output_not_finite(monkeypatch):
    def nan(infer, model, x, **kw):
        depth, feats = infer(model, x, **kw)
        return depth.clone().index_fill_(0, torch.tensor([0]), float("nan")), feats

    _wrap_infer(monkeypatch, nan)
    out = run_cell()
    assert out["failed"] == out["attempted"] > 0
    assert out["checks"]["depth_gap"][0] == depth_driver.GAP_MAX
    assert out["checks"]["png_gap"][0] == 1.0
    assert not verdict(out["checks"])
