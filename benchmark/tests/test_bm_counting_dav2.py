"""The operation count and the attention bound behind `mfu.depth` and
`k1_roofline_pct.eval` in the Depth Anything V2 cell, against hand
counts at the published widths. (`tests/test_torch_depth_anything_v2.py`
holds the same formulas equal to PyTorch's flop counter on the port at a
tiny size.)"""

from __future__ import annotations

import pytest

from benchmark import counting_dav2
from benchmark.run import resolve

CFG = resolve("dav2l-depth-b8-518x686")["config"]
N = 37 * 49 + 1  # the 518 x 686 input's patches and the class token


def test_grid_of_the_bucket():
    assert counting_dav2.grid(CFG, 518, 686) == (37, 49)
    assert counting_dav2.scales(37, 49) == [(148, 196), (74, 98), (37, 49), (19, 25)]


def test_encoder_flops():
    d = 1024
    block = 2 * N * 12 * d * d + 4 * 16 * N * N * 64
    want = 24 * block + 2 * (N - 1) * 3 * 14 * 14 * d
    assert counting_dav2.encoder_flops(CFG, 37, 49) == pytest.approx(want, rel=1e-12)


def test_published_size_of_the_step():
    step = counting_dav2.step_flops(CFG, 8, 518, 686)
    encoder = 8 * counting_dav2.encoder_flops(CFG, 37, 49)
    head = 8 * counting_dav2.head_flops(CFG, 37, 49)
    assert 11.3e12 < encoder < 11.4e12  # 8.76 in the linears, 2.59 in attention
    assert 3.0e12 < head < 3.2e12  # the fusion blocks at 148 x 196, the head at 518 x 686
    assert step == pytest.approx(encoder + head, rel=1e-12)


def test_attention_bound_is_the_operations():
    ops_s = 4 * 8 * 16 * N * N * 64 / 989e12
    bytes_s = 4 * 8 * 16 * N * 64 * 2 / 3.35e12
    assert ops_s > bytes_s  # no bias: K1 is bound by its products here
    assert counting_dav2.step_attention_bound_s(CFG, 8, 518, 686) == pytest.approx(
        24 * ops_s, rel=1e-12)


def test_roofline_reader_reads_the_kernel_without_a_bias():
    """`k1_roofline_pct.eval`, which the cell reports, sums K1's launches:
    in this cell only its `BIAS` 0 instantiation runs (the model has no
    attention bias), and the reader reads nothing from a trace without K1."""
    from benchmark.run import BENCH_DIR, load_module

    reader = load_module(BENCH_DIR / "metrics" / "k1_roofline_pct.eval.py", "k1_eval")
    bound = counting_dav2.step_attention_bound_s(CFG, 8, 518, 686)
    kernels = [("void attn_bf16_wgmma_kernel<0, 2, false>(CUtensorMap)", 0.004),
               ("void attn_bf16_wgmma_kernel<0, 1, true>(CUtensorMap)", 0.001),
               ("ampere_bf16_s16816gemm", 1.0)]
    out = {"trace": {"kernels": kernels, "steps": 2}, "counts": {"attention_bound_s": bound}}
    assert reader.read({}, out) == pytest.approx(100.0 * bound * 2 / 0.005)
    out["trace"]["kernels"] = kernels[2:]
    assert reader.read({}, out) is None
