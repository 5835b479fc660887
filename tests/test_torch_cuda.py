"""Tests of the PyTorch port that need a CUDA card (marker ``cuda``).

They skip without one. This file imports neither JAX nor the JAX package,
so it runs on a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX.) Each kernel is
held against its plain PyTorch version on the same inputs: the attention
kernel at max abs error 1e-4 in float32; in bf16 at relative error
||out - ref|| / ||ref|| <= 5e-3 (plus max abs error 2e-2). The relative
limit is what sees a wrong kernel in bf16: with randn inputs each output
averages hundreds of keys, so outputs are ~0.04 (max ~0.3) at N=1601 and a
bug that shrinks every output by 2% moves them by less than 1e-2, while
bf16 rounding of P and of the output gives a relative error near 3e-3.
The int8 CRF product is held exactly.
"""

import pytest
import torch

from depthg_tpu_torch.ops import attention as tatt
from depthg_tpu_torch.ops import crf as tcrf

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# dtype -> (max abs error, relative error ||out - ref|| / ||ref||)
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 5e-3)}


def _assert_close(out, ref, dtype):
    atol, rtol = TOL[dtype]
    diff = out.float() - ref.float()
    assert diff.abs().max().item() <= atol
    assert (diff.norm() / ref.float().norm()).item() <= rtol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,n_valid,heads", [(1601, 1601, 6), (1664, 1601, 6),
                                             (200, 130, 6), (77, 77, 3)])
def test_attention_kernel_matches_plain(cuda, dtype, n, n_valid, heads):
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, n, 3 * 64 * heads, generator=gen).to(cuda, dtype)
    before = tatt.KERNEL.launches
    out = tatt.attention_qkv(qkv, heads, 0.125, n_valid)
    torch.cuda.synchronize()
    assert tatt.KERNEL.launches == before + 1
    q, k, v = tatt.split_qkv(qkv, heads)
    ref = tatt.attention_plain(q, k, v, 0.125, n_valid).permute(0, 2, 1, 3)
    _assert_close(out, ref.reshape(out.shape), dtype)
    assert torch.all(out[:, n_valid:] == 0)


def test_attention_kernel_split_operands(cuda):
    """The split [B, H, N, 64] layout of the TPU's ``whole_kv_mha`` through
    the same kernel: contiguous operands, other strides."""
    qkv = torch.randn(2, 300, 3 * 192, device=cuda, dtype=torch.bfloat16)
    q, k, v = (t.contiguous() for t in tatt.split_qkv(qkv, 3))
    out = tatt._launch(q, k, v, torch.empty_like(q), 0.125, 250)
    ref = tatt.attention_plain(q, k, v, 0.125, 250)
    _assert_close(out[:, :, :250], ref[:, :, :250], torch.bfloat16)
    assert torch.all(out[:, :, 250:] == 0)


def test_attention_kernel_ignores_masked_keys(cuda):
    qkv = torch.randn(1, 300, 3 * 128, device=cuda, dtype=torch.bfloat16)
    out = tatt.attention_qkv(qkv, 2, 0.125, 250)
    qkv[:, 250:, 128:] = float("inf")
    torch.testing.assert_close(tatt.attention_qkv(qkv, 2, 0.125, 250), out,
                               rtol=0, atol=0)


def test_attention_kernel_rejects_misaligned_rows(cuda):
    qkv = torch.randn(1, 64, 3 * 128 + 1, device=cuda)[..., 1:]  # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        tatt.attention_qkv(qkv, 2, 0.125)


def test_int8_product_exact_on_card(cuda):
    """torch._int_mm (int32 sums) == the CPU's float64 product: both exact."""
    gen = torch.Generator().manual_seed(1)
    k8 = torch.randint(-127, 128, (2, 1600, 1600), generator=gen, dtype=torch.int8)
    z8 = torch.randint(-127, 128, (2, 1600, 54), generator=gen, dtype=torch.int8)
    ref = tcrf._int8_matmul(k8, z8)
    out = tcrf._int8_matmul(k8.to(cuda), z8.to(cuda))
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)


def test_cached_matmul_close_on_card(cuda):
    """Quantizing z may round one step apart where the card's and the CPU's
    float32 scaling differ by an ulp: within one step of zmax/127 per term."""
    gen = torch.Generator().manual_seed(2)
    k8 = torch.randint(0, 128, (1, 1600, 1600), generator=gen, dtype=torch.int8)
    z = torch.rand(1, 1600, 54, generator=gen)
    ref = tcrf.cached_matmul(k8, z, torch.float32)
    out = tcrf.cached_matmul(k8.to(cuda), z.to(cuda), torch.float32).cpu()
    assert (out - ref).abs().max() <= 1600 * (1.0 / 127)
    assert (out - ref).abs().mean() <= 1e-3 * ref.abs().mean()
