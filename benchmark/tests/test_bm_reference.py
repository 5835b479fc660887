"""The port against the plain reference at tiny sizes on the CPU: float32
(the same arithmetic, so the gaps are rounding) and the configurations'
bfloat16 backbone."""

from __future__ import annotations

import pytest
import torch

from benchmark import common
from benchmark.drivers import eval as eval_driver
from benchmark.drivers import train as train_driver
from benchmark.reference import train as train_ref
from benchmark.tests._tiny import tiny_spec
from benchmark.weights import make_state_dict

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("dtype,limit", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_eval_blocks_match(dtype, limit):
    spec = tiny_spec("vits8-eval-default")
    spec["config"]["eval"]["backbone_dtype"] = dtype
    cfg, tr = spec["config"], spec["traffic"]
    model, step = eval_driver.build_program(cfg, 11, CPU)
    ring = eval_driver.make_ring(cfg, tr, 11, CPU)
    outs = {i: step(model, ring[i]["img"], ring[i]["label"]) for i in range(2)}
    ref = eval_driver.reference_blocks(cfg, 11, ring, [0, 1], CPU)
    for i in range(2):
        for p, r in zip(outs[i], ref[i]):
            assert int(p.sum()) == int(r.sum()) == eval_driver.labelled(ring[i], 27)
    assert eval_driver.worst_gap(cfg, ring, outs, ref) <= limit


@pytest.mark.parametrize("dtype,limits", [
    ("float32", {"loss_gap": 1e-6, "grad_gap": 1e-5, "update_gap_median": 1e-5}),
    ("bfloat16", {"loss_gap": 1e-3, "grad_gap": 3e-2, "update_gap_median": 3e-2})])
def test_train_steps_match(dtype, limits):
    spec = tiny_spec("vits8-train-b32")
    spec["config"]["train"]["backbone_dtype"] = dtype
    cfg, tr = spec["config"], spec["traffic"]
    prog = train_driver.Program(cfg, 5, CPU)
    ring = train_driver.make_ring(cfg, tr, 5, CPU)
    gaps = train_driver.compare(prog.first_steps(ring),
                                train_driver.reference(cfg, 5, ring, CPU))
    for k, lim in limits.items():
        assert gaps[k] <= lim, (k, gaps)


def test_reference_fps_coordinates_match_the_port():
    from depthg_tpu_torch.ops.depth import farthest_point_sampling_depth

    gen = torch.Generator().manual_seed(3)
    depth = torch.rand((3, 1, 64, 64), generator=gen)
    feats = torch.zeros((3, 8, 8, 8))
    want = farthest_point_sampling_depth(feats, depth, 4) * 2 - 1
    assert torch.equal(train_ref.fps_coords(depth, 8, 8, 4), want)


def test_weights_are_drawn_alike_from_a_seed():
    spec = tiny_spec("vits8-train-b32")
    a = make_state_dict(spec["config"], common.stream_seed(2 ** 33 + 1, "weights"), CPU, True)
    b = make_state_dict(spec["config"], common.stream_seed(2 ** 33 + 1, "weights"), CPU, True)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
