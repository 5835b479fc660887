"""Each fault the Depth Anything V2 cell can have, planted in the program
under a run that skips only the look for a card, turns `correct` false,
and the number meant to catch it is the one that fails; a sound run
passes. The program runs in float32 here, so a sound run reads 0. A late hook moves one tap by one block's residual: at the
configuration's LayerScale 0.1 and the tiny size that is below the card's
limit, so that fault runs the blocks at LayerScale 1."""

from __future__ import annotations

import time

import pytest
import torch

import depthg_tpu_torch.models.depth_anything_v2 as dav2
from benchmark.drivers import depth_dav2 as driver
from benchmark.drivers.depth import GAP_MAX
from benchmark.run import verdict
from benchmark.tests._tiny_dav2 import tiny_dav2_spec
from depthg_tpu_torch.models import vit

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run_cell(layer_scale=None):
    spec = tiny_dav2_spec()
    cfg = spec["config"]
    cfg["infer"]["dtype"] = "float32"
    if layer_scale is not None:
        cfg["init"]["layer_scale"] = layer_scale
    return driver.run(spec, seed=2 ** 31 + 17, seconds=0.3, trace=False, dev=CPU,
                      t_start=time.perf_counter())


def fails_on_depth_gap(out):
    checks = out["checks"]
    assert checks["depth_gap"][0] > checks["depth_gap"][1]
    assert not verdict(checks)


def test_sound_run_passes():
    out = run_cell()
    assert out["failed"] == 0 and out["attempted"] > 0
    assert {k: v for k, (v, _) in out["checks"].items()} == {"depth_gap": 0.0}
    assert verdict(out["checks"])


def test_raw_taps(monkeypatch):
    def raw(self, x, blocks, attn_impl="xla"):
        x = self.prepare_tokens(x)
        out = {}
        for i, blk in enumerate(self.blocks[:max(blocks) + 1]):
            x, _, _ = blk(x, attn_impl)
            out[i] = x[:, self.cfg.n_prefix:]
        return [out[i] for i in blocks]

    monkeypatch.setattr(vit.VisionTransformer, "normed_taps", raw)
    fails_on_depth_gap(run_cell())


def test_first_hook_late(monkeypatch):
    taps = vit.VisionTransformer.normed_taps
    monkeypatch.setattr(vit.VisionTransformer, "normed_taps",
                        lambda self, x, blocks, attn_impl="xla":
                        taps(self, x, [blocks[0] + 1, *blocks[1:]], attn_impl))
    fails_on_depth_gap(run_cell(layer_scale=1.0))


def test_not_normalized(monkeypatch):
    monkeypatch.setattr(dav2, "normalize", lambda x: x.float())
    fails_on_depth_gap(run_cell())


def test_layer_scale_left_out(monkeypatch):
    monkeypatch.setattr(vit.LayerScale, "forward", lambda self, x: x)
    fails_on_depth_gap(run_cell())


def _wrap_forward(monkeypatch, change):
    forward = dav2.DepthAnythingV2.forward
    monkeypatch.setattr(dav2.DepthAnythingV2, "forward",
                        lambda self, x, attn_impl="auto": change(*forward(self, x, attn_impl)))


def test_half_batch_unwritten(monkeypatch):
    _wrap_forward(monkeypatch, lambda d, hooks: (torch.cat(
        [d[: len(d) // 2], torch.zeros_like(d[len(d) // 2:])]), hooks))
    fails_on_depth_gap(run_cell())


def test_output_not_finite(monkeypatch):
    _wrap_forward(monkeypatch, lambda d, hooks: (
        d.clone().index_fill_(0, torch.tensor([0]), float("nan")), hooks))
    out = run_cell()
    assert out["failed"] == out["attempted"] > 0
    assert out["checks"]["depth_gap"][0] == GAP_MAX
    assert set(out["checks"]) == {"depth_gap"}
    assert not verdict(out["checks"])
