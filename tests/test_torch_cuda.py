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
The bilateral message kernel (K4, ``csrc/crf_bilateral.cu``) is held to the
relative errors 1e-5 (float32) and 5e-3 (bf16), and to a max abs error
scaled by the largest output (``K4_MAX_TOL``). The int8 CRF product is held
exactly.
"""

import pytest
import torch

from depthg_tpu_torch.ops import attention as tatt
from depthg_tpu_torch.ops import crf as tcrf
from depthg_tpu_torch.ops import crf_bilateral as tbil

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
                                             (200, 130, 6), (77, 77, 3), (128, 128, 6),
                                             (129, 129, 3), (256, 256, 6), (257, 200, 3),
                                             (640, 513, 6)])
def test_attention_kernel_matches_plain(cuda, dtype, n, n_valid, heads):
    """Whole and ragged last tiles of 128 keys and of the 256-row query
    blocks (1601 = 12 x 128 + 65), n_valid < N, 3 and 6 heads."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_noncontiguous_batch(cuda, dtype):
    """Packed qkv as a view of a longer buffer: the batch stride is not
    N x 3D, and what lies past N (NaN here) is never read."""
    gen = torch.Generator().manual_seed(3)
    big = torch.randn(3, 340, 3 * 384, generator=gen).to(cuda, dtype)
    big[:, 300:] = float("nan")
    qkv = big[:, :300]
    assert not qkv.is_contiguous()
    out = tatt.attention_qkv(qkv, 6, 0.125, 290)
    ref = tatt.attention_qkv(qkv.contiguous(), 6, 0.125, 290)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    q, k, v = tatt.split_qkv(qkv.contiguous(), 6)
    plain = tatt.attention_plain(q, k, v, 0.125, 290).permute(0, 2, 1, 3)
    _assert_close(out, plain.reshape(out.shape), dtype)


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


@pytest.mark.parametrize("offset", [1, 4])
def test_attention_kernel_rejects_misaligned_bf16_views(cuda, offset):
    """A bf16 view whose base (2- or 8-byte offset) or row stride is not a
    multiple of 16 bytes cannot take a tensor map: the wrapper raises, and
    there is no second path."""
    buf = torch.randn(1, 64, 3 * 128 + offset, device=cuda).bfloat16()
    before = tatt.KERNEL.launches
    with pytest.raises(ValueError, match="aligned"):
        tatt.attention_qkv(buf[..., offset:], 2, 0.125)
    assert tatt.KERNEL.launches == before


# K4: dtype -> limit on the relative error and on max abs error / max |ref|.
# In bf16 both sides round float32 sums that agree to ~1e-6 to bf16, so they
# may land one bf16 step apart: 2^-8 of the value, under 1e-2 of the largest.
K4_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
K4_MAX_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _assert_k4_close(out, ref, dtype):
    diff = out.float() - ref.float()
    assert (diff.norm() / ref.float().norm()).item() <= K4_TOL[dtype]
    assert diff.abs().max().item() <= K4_MAX_TOL[dtype] * ref.float().abs().max().item()


def _bilateral_inputs(b, n, c, dtype, seed=0):
    """Features spread like the CRF's (positions over ~5 sigmas, colors over
    ~20), so kernel entries range from 1 down to far below bf16's reach;
    values in [0, 1) like the mean-field distributions."""
    gen = torch.Generator().manual_seed(seed)
    feats = torch.rand(b, n, 5, generator=gen) * torch.tensor([5.0, 5, 20, 20, 20])
    values = torch.rand(b, n, c, generator=gen)
    return feats, values.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c", [(2, 1000, 27), (2, 1000, 54), (2, 1000, 1),
                                   (1, 4099, 54), (2, 64, 5), (1, 777, 70)])
def test_bilateral_kernel_matches_plain(cuda, dtype, b, n, c):
    """K4 vs ``bilateral_message_plain``: any N (1000, 4099 and 777 end in a
    ragged key tile), C in {1, 27, 54}, and C = 70 over two channel chunks."""
    feats, values = _bilateral_inputs(b, n, c, dtype)
    ref = tbil.bilateral_message_plain(feats, values)
    before = tbil.KERNEL.launches
    out = tbil.bilateral_message(feats.to(cuda), values.to(cuda))
    torch.cuda.synchronize()
    assert tbil.KERNEL.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, n, c)
    _assert_k4_close(out.cpu(), ref, dtype)


@pytest.mark.parametrize("c", [1, 27, 54, 65])
def test_bilateral_rows_kernel_ragged_scene_size(cuda, c):
    """The row-blocked bf16 kernel (4 query rows per thread, 128-key tiles,
    wgmma value product) at the ds=2 scene size with a ragged edge:
    N = 25,563 read through views of a buffer that is NaN past it."""
    n, pad = 25_563, 37
    feats, values = _bilateral_inputs(1, n + pad, c, torch.bfloat16, seed=2)
    feats[..., :2] *= 12.0  # positions over ~60 sigmas, like a 160 x 160 grid
    ref = tbil.bilateral_message_plain(feats[:, :n].to(cuda).contiguous(),
                                       values[:, :n].to(cuda).contiguous())
    feats, values = feats.to(cuda), values.to(cuda)
    feats[:, n:], values[:, n:] = float("nan"), float("nan")
    out = torch.full_like(values, 7.0)
    before = tbil.KERNEL.launches
    tbil._launch(feats[:, :n], values[:, :n], out[:, :n])
    torch.cuda.synchronize()
    assert tbil.KERNEL.launches == before + 1
    _assert_k4_close(out[:, :n], ref, torch.bfloat16)
    assert torch.all(out[:, n:] == 7.0)


@pytest.mark.parametrize("b,n", [(2, 1000), (1, 25_563), (2, 128), (1, 129)])
def test_bilateral_degree_matches_plain(cuda, b, n):
    """The degree entry (K @ 1 in float32, no value product) vs the plain
    version on ones; the views' tails (NaN) are not read."""
    feats, _ = _bilateral_inputs(b, n + 9, 1, torch.float32, seed=4)
    ref = tbil.bilateral_message_plain(feats[:, :n].contiguous(), torch.ones(b, n, 1))
    feats = feats.to(cuda)
    feats[:, n:] = float("nan")
    before = tbil.KERNEL.launches
    out = tbil.bilateral_degree(feats[:, :n])
    torch.cuda.synchronize()
    assert tbil.KERNEL.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (b, n, 1)
    diff = out.cpu() - ref
    assert (diff.norm() / ref.norm()).item() <= 5e-5
    assert diff.abs().max().item() <= 5e-5 * ref.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilateral_kernel_reads_nothing_past_n(cuda, dtype):
    """Points past N (here NaN in a larger buffer the inputs are views of)
    weigh exactly 0 and are never written: the ragged last tile is masked
    in the kernel."""
    feats, values = _bilateral_inputs(2, 1100, 27, dtype, seed=1)
    feats, values = feats.to(cuda), values.to(cuda)
    ref = tbil.bilateral_message(feats[:, :1000].contiguous(),
                                 values[:, :1000].contiguous())
    feats[:, 1000:] = float("nan")
    values[:, 1000:] = float("nan")
    out = torch.full_like(values, 7.0)
    tbil._launch(feats[:, :1000], values[:, :1000], out[:, :1000])
    torch.cuda.synchronize()
    torch.testing.assert_close(out[:, :1000], ref, rtol=0, atol=0)
    assert torch.all(out[:, 1000:] == 7.0)


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
