"""The operation counts and the attention bound behind `mfu.depth` and
`k1b_roofline_pct.depth`, against hand counts at the published widths.
(`tests/test_torch_zoedepth_reference.py` holds the same formulas equal to
PyTorch's flop counter on the port at a tiny size.)"""

from __future__ import annotations

import pytest

from benchmark import counting_depth
from benchmark.run import resolve

CFG = resolve("zoedepth-gen-b8")["config"]
N = 24 * 32 + 1  # the 384 x 512 network input's patches and the cls token


def test_network_input_of_the_bucket():
    # reflect-padded to 466 x 608, prepped back to 384 x 512
    assert counting_depth.net_size(CFG, 384, 512) == (384, 512)


def test_beit_flops():
    d = 1024
    block = 2 * N * 12 * d * d + 4 * 16 * N * N * 64
    want = 24 * block + 2 * 24 * 32 * 768 * d
    assert counting_depth.beit_flops(CFG, 24, 32) == pytest.approx(want, rel=1e-12)


def test_published_size_of_the_step():
    step = counting_depth.step_flops(CFG, 8, 384, 512)
    beit = 16 * counting_depth.beit_flops(CFG, 24, 32)
    assert 8.3e12 < beit < 8.5e12  # two passes of 8 images: ~8.4 TFLOP
    assert 11.3e12 < step < 11.6e12  # with DPT's and the head's convolutions: ~11.5
    assert step == pytest.approx(16 * counting_depth.forward_flops(CFG, 384, 512), rel=1e-12)


def test_attention_bound_counts_the_bias_bytes():
    bytes_s = (4 * 8 * 16 * N * 64 * 2 + 16 * N * N * 2) / 3.35e12
    ops_s = 4 * 8 * 16 * N * N * 64 / 989e12
    assert bytes_s > ops_s  # q, k, v, o and the bias bound K1b here
    assert counting_depth.step_attention_bound_s(CFG, 8, 384, 512) == pytest.approx(
        48 * bytes_s, rel=1e-12)
