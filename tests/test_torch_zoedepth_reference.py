"""The port's ZoeDepth against the benchmark's plain reference
(``benchmark/reference/zoedepth.py``, written from the published model), on
the CPU at a tiny size: BEiT of 4 blocks, 64 wide, 4 heads, a hook at every
block, a 6 x 6 pretraining window resized to the 4 x 6 grid of a 64 x 96
network input; DPT features 32; 16 bins; attractors (4, 2, 2, 1)
(``benchmark/tests/_tiny_depth.py``). Both take one state dict drawn from
a seed at the configuration's assumed magnitudes
(``benchmark.weights_zoedepth``), which the port loads with
``strict=True``.

Tolerances: float32 1e-4 of the largest value (the same arithmetic, so
only rounding; measured 0); bfloat16 (the port cast by
``generate_depth.to_dtype``, the reference in float32) 2e-2 in norm, from
bf16's 2^-9 relative rounding of every stored weight and activation
through ~40 products and the head's softplus, attractor and log-binomial
arithmetic (measured 1.7e-3 to 6.5e-3 over three seeds, here and with the
BEiT below). The reference with its relative-position bias left out, or
with its last attractor stage skipped, fails both: the comparisons can
fail. At this size the bias moves the depth by less than bf16 rounding
does, so its bf16 case runs a BEiT of 8 blocks of 256 (16 heads of 16) at
LayerScale 1 (measured 0.048 to 0.139). The benchmark's operation count
of the forward equals PyTorch's ``FlopCounterMode`` on the port. The
reference imports torch alone and runs with TF32 off.
"""

import ast
import copy
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counting_depth
from benchmark.drivers import depth as depth_driver
from benchmark.reference import zoedepth as zref
from benchmark.tests._tiny_depth import tiny_depth_spec
from benchmark.weights_zoedepth import make_state_dict, param_specs
from depthg_tpu_torch.generate_depth import to_dtype
from depthg_tpu_torch.models.zoedepth.model import ZoeDepth, zoedepth_infer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SPEC = tiny_depth_spec()
CFG, TR = SPEC["config"], SPEC["traffic"]
CPU = torch.device("cpu")
F32 = 1e-4
BF16 = 2e-2


def _models(cfg):
    sd = make_state_dict(cfg, 7, CPU)
    model = ZoeDepth(depth_driver.zoe_config(cfg))
    model.load_state_dict(sd, strict=True)
    img = depth_driver.make_ring(TR, 7, CPU)[0]
    return sd, model.eval(), img


@pytest.fixture(scope="module")
def models():
    return _models(CFG)


def wide_config():
    cfg = copy.deepcopy(CFG)
    cfg["init"]["layer_scale"] = 1.0
    cfg["beit"].update(embed_dim=256, num_heads=16, depth=8, hooks=[1, 3, 5, 7])
    return cfg


def rel_max(got, ref):
    return float((got.float() - ref).abs().max() / ref.abs().max())


def rel_norm(got, ref):
    return float((got.float() - ref).norm() / ref.norm())


def prepped(img):
    return (img - 0.5) / 0.5  # the 64 x 96 image is its own network input


def test_state_dict_is_the_ports(models):
    _, model, _ = models
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {name: shape for name, shape, _, _ in param_specs(CFG)} == want


def test_forward_float32(models):
    sd, model, img = models
    x = prepped(img)
    with torch.no_grad():
        got = model(x)
    ref = zref.forward(sd, CFG, x)
    assert got["metric_depth"].shape == (2, 1, 64, 96)
    for name in ("rel_depth", "metric_depth", "feats"):
        assert rel_max(got[name], ref[name]) <= F32, name


def test_infer_float32(models):
    """Reflect pad, prep, bicubic back, crop and the flip, averaged."""
    sd, model, img = models
    with torch.no_grad():
        depth, feats = zoedepth_infer(model, img, return_feats=True)
    ref_depth, ref_feats = zref.infer(sd, CFG, img)
    assert depth.shape == (2, 1, 64, 96)
    assert rel_max(depth, ref_depth) <= F32 and rel_max(feats, ref_feats) <= F32


def test_bfloat16(models):
    sd, model, img = models
    m16 = to_dtype(copy.deepcopy(model), "bfloat16")
    with torch.no_grad():
        fwd = m16(prepped(img).bfloat16())["metric_depth"]
        depth = zoedepth_infer(m16, img.bfloat16())
    assert rel_norm(fwd, zref.forward(sd, CFG, prepped(img))["metric_depth"]) <= BF16
    assert rel_norm(depth, zref.infer(sd, CFG, img)[0]) <= BF16


@pytest.mark.parametrize("fault", [dict(rel_bias=False), dict(attractors=3)],
                         ids=["bias_left_out", "last_attractor_skipped"])
def test_a_fault_in_the_reference_fails_the_float32_tolerance(models, fault):
    sd, model, img = models
    with torch.no_grad():
        got = zoedepth_infer(model, img)
    assert rel_max(got, zref.infer(sd, CFG, img, **fault)[0]) > F32


@pytest.mark.parametrize("fault, wide", [(dict(rel_bias=False), True),
                                         (dict(attractors=3), False)],
                         ids=["bias_left_out", "last_attractor_skipped"])
def test_a_fault_in_the_reference_fails_the_bfloat16_tolerance(models, fault, wide):
    cfg = wide_config() if wide else CFG
    sd, model, img = _models(cfg) if wide else models
    m16 = to_dtype(copy.deepcopy(model), "bfloat16")
    with torch.no_grad():
        got = zoedepth_infer(m16, img.bfloat16())
    assert rel_norm(got, zref.infer(sd, cfg, img)[0]) <= BF16
    assert rel_norm(got, zref.infer(sd, cfg, img, **fault)[0]) > BF16


def test_operation_count_is_the_flop_counters(models):
    """``counting_depth`` from the widths against ``FlopCounterMode`` on the
    port's forward (the eager attention on the CPU: its two products)."""
    _, model, img = models
    with torch.no_grad():
        with FlopCounterMode(display=False) as forward:
            model(prepped(img))
        with FlopCounterMode(display=False) as step:
            zoedepth_infer(model, img)
    assert counting_depth.net_size(CFG, 64, 96) == (64, 96)
    assert forward.get_total_flops() == 2 * counting_depth.forward_flops(CFG, 64, 96)
    assert step.get_total_flops() == counting_depth.step_flops(CFG, 2, 64, 96)


def test_reference_imports_torch_alone():
    path = ROOT / "benchmark" / "reference" / "zoedepth.py"
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "contextlib", "math", "torch"}


def test_reference_runs_without_tf32(monkeypatch):
    seen = []
    real = zref.infer

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(*args, **kwargs)

    monkeypatch.setattr(zref, "infer", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    sd = make_state_dict(CFG, 3, CPU)
    zref.depth_maps(sd, CFG, torch.rand(1, 3, 64, 96, generator=torch.Generator().manual_seed(0)))
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
