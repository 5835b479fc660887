"""The operation counts and bounds behind `mfu.*` and
`k1_roofline_pct.eval`, against hand counts for both configurations."""

from __future__ import annotations

import pytest

from benchmark import counting
from benchmark.run import resolve

CELLS = {"vits8-eval-default": (384, 6, 70), "vitb8-eval-default": (768, 12, 90)}


def hand_vit(d: int, res: int) -> float:
    """12 blocks of 12 d^2 weights (2 operations each per token) and two
    T x T x d attention products, plus the 8x8x3 -> d patch embedding."""
    t = (res // 8) ** 2 + 1
    return 12 * (2 * t * 12 * d * d + 2 * 2 * t * t * d) + 2 * (t - 1) * 192 * d


def hand_head(d: int, dim: int, res: int) -> float:
    n = (res // 8) ** 2
    return 2 * n * (d * dim + d * d + d * dim)


def hand_probes(dim: int, res: int) -> float:
    return 2 * (res // 8) ** 2 * dim * 27 * 2


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_eval_step_flops(cell):
    d, _, dim = CELLS[cell]
    cfg = resolve(cell)["config"]
    want = 16 * (2 * (hand_vit(d, 320) + hand_head(d, dim, 320)) + hand_probes(dim, 320))
    assert counting.eval_step_flops(cfg, 16) == pytest.approx(want, rel=1e-12)


def test_published_sizes_of_the_eval_steps():
    s = counting.eval_step_flops(resolve("vits8-eval-default")["config"], 16)
    b = counting.eval_step_flops(resolve("vitb8-eval-default")["config"], 16)
    assert 3.6e12 < s < 3.8e12  # ~3.7 TFLOP of model work a step
    assert 11.5e12 < b < 12.0e12  # ~11.7 TFLOP, 3.2x ViT-S/8's


def test_train_step_flops():
    cfg = resolve("vits8-train-b32")["config"]
    want = 32 * (2 * hand_vit(384, 224) + 6 * hand_head(384, 70, 224) + 3 * hand_probes(70, 224))
    assert counting.train_step_flops(cfg, 32) == pytest.approx(want, rel=1e-12)
    assert 2.8e12 < want < 3.0e12


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_attention_bound(cell):
    d, heads, _ = CELLS[cell]
    cfg = resolve(cell)["config"]
    t = 1601
    ops_s = 4 * 32 * heads * t * t * 64 / 989e12
    bytes_s = 4 * 32 * heads * t * 64 * 2 / 3.35e12
    assert ops_s > bytes_s  # operations bound this attention
    assert counting.eval_attention_bound_s(cfg, 16) == pytest.approx(12 * ops_s, rel=1e-12)
    # one call over both TTA passes = two calls over one: same bound
    assert 12 * counting.attention_bound_s(32, t, heads) == pytest.approx(
        24 * counting.attention_bound_s(16, t, heads), rel=1e-12)
