"""DINOv2's SwiGLU gate (``ops.swiglu``) on the CPU.

* ``swiglu_gate`` on a CPU tensor is its plain version and the module's
  former eager ``F.silu(a) * b``, bit for bit, in bf16 and float32, at the
  DINOv2 cell's half width (H = 4,096) and a small one, over 1, 7 and
  1,029 rows; it never builds or counts the kernel.
* ``SwiGLU.forward`` on the tiny DINOv2 configuration (hidden 176 by the
  published formula) goes through ``swiglu_gate`` once a block and returns
  ``w3(F.silu(a) * b)`` bit for bit, in both dtypes.
* The kernel's terms (``_check``, which the CUDA path applies before it
  launches): an odd last dimension, H off a multiple of 8, a strided or
  misaligned input, one that requires grad, float16 and an empty input are
  refused; ``w12``'s output as ``F.linear`` and the int8 copy's
  ``W8A8Linear`` leave it is taken.

The kernel itself runs on the card only (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from depthg_tpu_torch.models import vit as tvit
from depthg_tpu_torch.ops import swiglu as tswi

# the tracing tests' tiny DINOv2 (registers, LayerScale, SwiGLU hidden 176)
DINOV2_VIT = dict(patch_size=14, embed_dim=64, depth=3, num_heads=4, img_size=70, n_registers=2,
                  layer_scale=True, ffn="swiglu", pos_resize="dinov2")


def w12_output(m: int, hidden: int, dtype, seed: int = 0) -> torch.Tensor:
    """[m, 2H] spread like a trained ``w12`` output, with the gate's far
    ends (exp(-x) overflowing, silu(x) = x) on a few entries."""
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(m, 2 * hidden, generator=gen) * 3.0
    h.view(-1)[:: 97] = 100.0
    h.view(-1)[5:: 89] = -100.0
    return h.to(dtype)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("m", [1, 7, 1029])
@pytest.mark.parametrize("hidden", [4096, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gate_on_the_cpu_is_the_eager_gate(monkeypatch, dtype, hidden, m):
    def no_kernel():
        raise AssertionError("the CPU built the kernel")

    monkeypatch.setattr(tswi.KERNEL, "fn", no_kernel)
    before = tswi.KERNEL.gate_launches
    h = w12_output(m, hidden, dtype, seed=m + hidden)
    got = tswi.swiglu_gate(h)
    a, b = h.chunk(2, dim=-1)
    eager = F.silu(a) * b
    assert got.shape == (m, hidden) and got.dtype == dtype
    assert torch.equal(bits(got), bits(eager))
    assert torch.equal(bits(got), bits(tswi.swiglu_gate_plain(h)))
    assert tswi.KERNEL.gate_launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_swiglu_forward_unchanged_on_the_tiny_dinov2(monkeypatch, dtype):
    cfg = tvit.ViTConfig(**DINOV2_VIT)
    model = tvit.VisionTransformer(cfg).init_weights(torch.Generator().manual_seed(0))
    model = model.to(dtype).eval()
    calls = []
    gate = tvit.swiglu_gate

    def recorded(h):
        calls.append(h.shape)
        return gate(h)

    monkeypatch.setattr(tvit, "swiglu_gate", recorded)
    x = torch.randn(2, 11, cfg.embed_dim, generator=torch.Generator().manual_seed(1)).to(dtype)
    with torch.no_grad():
        for blk in model.blocks:
            mlp = blk.mlp
            a, b = mlp.w12(x).chunk(2, dim=-1)
            want = mlp.w3(F.silu(a) * b)
            got = mlp(x)
            assert torch.equal(bits(got), bits(want))
            x = x + got
        feats, _, _ = model(torch.randn(2, 3, 56, 56, generator=torch.Generator().manual_seed(2))
                            .to(dtype))
    hidden = tvit.swiglu_hidden(cfg)
    assert hidden == 176
    # one gate a block from the loop above, one a block from the forward (a 4 x 4
    # grid, the class token and 2 registers)
    assert calls == [(2, 11, 2 * hidden)] * cfg.depth + [(2, 19, 2 * hidden)] * cfg.depth
    assert torch.isfinite(feats[0]).all()


def _refused(bad: str) -> torch.Tensor:
    h = w12_output(7, 16, torch.bfloat16)
    if bad == "odd_width":
        return h[:, :31].contiguous()
    if bad == "half_width_not_a_multiple_of_8":
        return h[:, :24].contiguous()
    if bad == "strided":
        return w12_output(7, 32, torch.bfloat16)[:, :32]
    if bad == "misaligned":
        return w12_output(1, 16 * 8, torch.bfloat16).view(-1)[4: 4 + 7 * 32].view(7, 32)
    if bad == "requires_grad":
        return h.float().requires_grad_()
    if bad == "float16":
        return h.half()
    return h[:0]  # empty


@pytest.mark.parametrize("bad", ["odd_width", "half_width_not_a_multiple_of_8", "strided",
                                 "misaligned", "requires_grad", "float16", "empty"])
def test_the_kernel_terms_refuse_what_it_cannot_take(bad):
    h = _refused(bad)
    if bad == "misaligned":
        assert h.data_ptr() % 16 and h.is_contiguous()
    with pytest.raises(ValueError):
        tswi._check(h)


def test_the_kernel_terms_take_w12_outputs_bf16_float32_and_int8():
    """``w12``'s output of the tiny DINOv2's blocks, as ``F.linear`` leaves
    it in float32 and bf16 and as the int8 copy's ``W8A8Linear`` does,
    meets the kernel's terms under ``no_grad`` (not with grad on)."""
    cfg = tvit.ViTConfig(**DINOV2_VIT)
    model = tvit.VisionTransformer(cfg).init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 21, cfg.embed_dim, generator=torch.Generator().manual_seed(1))
    int8 = tvit.quantize_vit(model)
    with torch.no_grad():
        outs = [model.blocks[0].mlp.w12(x), int8.blocks[0].mlp.w12(x.bfloat16()),
                model.to(torch.bfloat16).blocks[0].mlp.w12(x.bfloat16())]
    for h, dtype in zip(outs, (torch.float32, torch.bfloat16, torch.bfloat16)):
        assert h.shape == (2, 21, 2 * tvit.swiglu_hidden(cfg)) and h.dtype == dtype
        tswi._check(h)
    with pytest.raises(ValueError):
        tswi._check(model.blocks[0].mlp.w12(x.bfloat16()))
