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
exactly. The training slice adds the attention kernel at the train step's
shape (B=32, N=785), depth FPS on the card vs the CPU including exact ties,
and one float32 train step on the card vs the CPU. The serving slice adds
the kernel at the serving buckets' and the KNN embedding's shapes, a served
round trip over HTTP and the KNN's top-k against float64. The depth slice
adds the per-head logit bias (BEiT) at the ZoeDepth shapes and small
ZoeDepth and DPT_Large models on the card against the CPU. The float32
bodies of both kernels (split TF32 on the tensor cores) are also held to
the CPU emulation of their arithmetic in ``tests/test_torch_f32_split.py``
(run here on the card's tensors; that file imports JAX only inside its
comparisons), within the same limits. The fine-tune slice adds the
kernel's refusal of a gradient it cannot give (it has no backward), float32
with the bias at NYU's 480 x 640 (N=1201), a small fine-tune step and a
small ZoeDepth-NK on the card against the CPU. The variants slice adds
LHP's depth affinity on the card against the CPU (zero-pattern flips only
within 2e-3 of the threshold, the mixed code 1e-5 relative), the
attention kernel's launches in one ``arch=dino_depth`` step, and the
pyramid in bf16 against float32 on the card (and float32 against the CPU,
1e-4 relative). The parallel slice adds the attention kernel launched from
two threads on two streams at once (the service's replicas): each output
equal to the same call alone, the launch count exact. The int8 slice adds
the w8a8 linear (``models/layers.linear_w8a8``: ``torch._int_mm`` between
torch passes) on the card against the CPU at ViT-S/8's and BEiT-L's widths
and at fewer than 17 rows (padded): the weight and activation codes and
scales equal, the int32 sums equal, the bf16 output within one bf16 step;
a width off a multiple of 8 raises; and a small int8 ViT and BEiT on the
card against the CPU (cosine > 0.999). The contract sweep runs K1 (both
dtypes, no bias or a bias in either dtype, N from 1 to 1664 against every
n_valid that crosses a sub-tile, block or key tile) and K4 (N across its
tiles, C across its chunks, the degree entry) into output memory that
held NaN, proved by the output's address: an element a kernel leaves
unwritten cannot pass by chance. The small-grid slice adds that sweep at
the grids the bias-free bf16 kernel chooses (``block_plan``: B=1-8 at
N=1601 with n_valid across the 128- and 256-row block edges, and N=769,
785 and 1201, whose last block one warpgroup walks), every grid choice
forced on poisoned output with the chosen grid's bits, and a bias-free
batch equal to its images one by one.
"""

import pytest
import torch

from depthg_tpu_torch.ops import attention as tatt
from depthg_tpu_torch.ops import crf as tcrf
from depthg_tpu_torch.ops import crf_bilateral as tbil
from test_torch_f32_split import emulate_attention, emulate_bilateral
from test_torch_poison import F6_CASES, TOL, k1_contract, poisoned

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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


def _padded_bias(heads, n, dtype, seed, scale=1.0):
    """A [heads, n, n] bias view of [heads, n, round_up(n, 8)] storage, as
    the BEiT module builds it."""
    gen = torch.Generator().manual_seed(seed)
    store = torch.randn(heads, n, -(-n // 8) * 8, generator=gen) * scale
    return store.to("cuda", dtype)[:, :, :n]


@pytest.mark.parametrize("dtype,bias_dtype,b,n,n_valid", [
    (torch.bfloat16, torch.bfloat16, 8, 769, 769), (torch.bfloat16, torch.bfloat16, 16, 769, 769),
    (torch.bfloat16, torch.float32, 8, 769, 769), (torch.bfloat16, torch.bfloat16, 2, 769, 700),
    (torch.bfloat16, torch.bfloat16, 1, 1345, 1345), (torch.bfloat16, torch.bfloat16, 3, 77, 77),
    (torch.float32, torch.float32, 8, 769, 769), (torch.float32, torch.float32, 16, 769, 769),
    (torch.float32, torch.bfloat16, 2, 769, 700), (torch.float32, torch.float32, 3, 77, 77),
    (torch.bfloat16, torch.bfloat16, 1, 1201, 1201), (torch.float32, torch.float32, 1, 1201, 1201),
    (torch.bfloat16, torch.bfloat16, 2, 577, 577), (torch.float32, torch.float32, 2, 577, 577),
    (torch.bfloat16, torch.bfloat16, 3, 769, 769), (torch.bfloat16, torch.bfloat16, 5, 769, 769),
    (torch.bfloat16, torch.bfloat16, 2, 769, 768), (torch.bfloat16, torch.bfloat16, 2, 769, 640),
    (torch.bfloat16, torch.bfloat16, 2, 769, 129), (torch.float32, torch.float32, 2, 769, 768),
    (torch.float32, torch.float32, 2, 769, 129)])
def test_attention_kernel_with_bias_matches_plain(cuda, dtype, bias_dtype, b, n, n_valid):
    """The per-head [H, N, N] logit bias (BEiT) at the ZoeDepth shapes (16
    heads, N=769 at 384x512, 577 at 384x384, 1345 at its portrait bucket,
    1201 at NYU's 480x640), a bias in either dtype, odd batches, n_valid < N
    (768: no row past the third 256-row block; 640, 129: a ragged key tile
    and query block) and a short N: kernel vs plain, a bias that acts, and
    rows past n_valid exactly 0."""
    gen = torch.Generator().manual_seed(11)
    qkv = torch.randn(b, n, 3 * 1024, generator=gen).to(cuda, dtype)
    bias = _padded_bias(16, n, bias_dtype, 12, scale=2.0)
    before, before_bias = tatt.KERNEL.launches, tatt.KERNEL.bias_launches
    out = tatt.attention_qkv(qkv, 16, 0.125, n_valid, bias=bias)
    torch.cuda.synchronize()
    assert tatt.KERNEL.launches == before + 1
    assert tatt.KERNEL.bias_launches == before_bias + 1
    q, k, v = tatt.split_qkv(qkv, 16)
    ref = tatt.attention_plain(q, k, v, 0.125, n_valid, bias=bias).permute(0, 2, 1, 3)
    _assert_close(out, ref.reshape(out.shape), dtype)
    assert torch.all(out[:, n_valid:] == 0)
    plain = tatt.attention_qkv(qkv, 16, 0.125, n_valid)
    assert float((plain.float() - out.float()).norm() / out.float().norm()) > 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_with_bias_whose_heads_lie_apart(cuda, dtype):
    """A bias whose head stride is not N x its row stride (the [16, 769,
    769] corner of [16, 800, 776] storage): kernel vs plain."""
    gen = torch.Generator().manual_seed(15)
    qkv = torch.randn(2, 769, 3 * 1024, generator=gen).to(cuda, dtype)
    bias = (torch.randn(16, 800, 776, generator=gen) * 2.0).to(cuda, dtype)[:, :769, :769]
    assert bias.stride() == (800 * 776, 776, 1)
    out = tatt.attention_qkv(qkv, 16, 0.125, bias=bias)
    q, k, v = tatt.split_qkv(qkv, 16)
    ref = tatt.attention_plain(q, k, v, 0.125, bias=bias).permute(0, 2, 1, 3)
    _assert_close(out, ref.reshape(out.shape), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_with_bias_batch_equals_image_by_image(cuda, dtype):
    """A batch of 8 with BEiT's bias gives each image the bits it gets alone:
    the blocks that share the bias's tiles mix nothing across images."""
    gen = torch.Generator().manual_seed(16)
    qkv = torch.randn(8, 769, 3 * 1024, generator=gen).to(cuda, dtype)
    bias = _padded_bias(16, 769, dtype, 17, scale=2.0)
    out = tatt.attention_qkv(qkv, 16, 0.125, bias=bias)
    alone = torch.cat([tatt.attention_qkv(qkv[i:i + 1], 16, 0.125, bias=bias) for i in range(8)])
    torch.testing.assert_close(out, alone, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_ignores_bias_past_n_valid(cuda, dtype):
    """+1e4 (or NaN) in the bias at keys and rows >= n_valid changes nothing."""
    gen = torch.Generator().manual_seed(13)
    qkv = torch.randn(2, 769, 3 * 1024, generator=gen).to(cuda, dtype)
    bias = _padded_bias(16, 769, dtype, 14)
    out = tatt.attention_qkv(qkv, 16, 0.125, 700, bias=bias)
    bias[:, :, 700:] = 1e4
    bias[:, 700:] = float("nan")
    torch.testing.assert_close(tatt.attention_qkv(qkv, 16, 0.125, 700, bias=bias), out,
                               rtol=0, atol=0)


@pytest.mark.parametrize("what", ["odd_stride", "offset_base", "strided_keys",
                                  "odd_head_stride"])
def test_attention_kernel_rejects_a_bias_it_cannot_read(cuda, what):
    qkv = torch.randn(1, 769, 3 * 1024, device=cuda, dtype=torch.bfloat16)
    if what == "odd_stride":
        bias = torch.randn(16, 769, 769, device=cuda, dtype=torch.bfloat16)
    elif what == "offset_base":
        bias = torch.randn(16, 769, 784, device=cuda, dtype=torch.bfloat16)[:, :, 1:770]
    elif what == "strided_keys":
        bias = torch.randn(16, 769, 2 * 776, device=cuda, dtype=torch.bfloat16)[:, :, ::2][:, :, :769]
    else:  # rows 8-aligned, heads an odd number of elements apart
        flat = torch.randn(16 * 769 * 776 + 16, device=cuda, dtype=torch.bfloat16)
        bias = flat.as_strided((16, 769, 769), (769 * 776 + 1, 776, 1))
    before = tatt.KERNEL.launches
    with pytest.raises(ValueError, match="bias"):
        tatt.attention_qkv(qkv, 16, 0.125, bias=bias)
    assert tatt.KERNEL.launches == before


@pytest.mark.parametrize("model_name", ["zoedepth", "midas"])
def test_tiny_depth_models_card_vs_cpu(cuda, model_name):
    """A 4-block, 128-wide ZoeDepth (LayerScale 0.1, so attention shows) and
    DPT_Large in float32 on the card (K1, with the bias for ZoeDepth) vs the
    CPU's plain path from the same weights: relative error of the depth
    within 1e-4 (TF32 is off)."""
    import copy

    from depthg_tpu_torch.models.midas_dpt import MidasDPT, MidasDPTConfig
    from depthg_tpu_torch.models.zoedepth import ZoeConfig, ZoeDepth, zoedepth_infer
    from depthg_tpu_torch.models.zoedepth.beit import BEiTConfig
    from depthg_tpu_torch.models.zoedepth.dpt import DPTConfig

    gen = torch.Generator().manual_seed(21)
    dpt = dict(features=32, reassemble_channels=(16, 32, 64, 64))
    x = torch.rand(2, 3, 96, 128, generator=gen)
    if model_name == "zoedepth":
        cpu = ZoeDepth(ZoeConfig(
            n_bins=16, bin_embedding_dim=16, img_size=(96, 128),
            beit=BEiTConfig(embed_dim=128, depth=4, num_heads=2, pretrain_window=4,
                            hooks=(0, 1, 2, 3), layer_scale_init=0.1),
            dpt=DPTConfig(embed_dim=128, **dpt))).init_weights(gen).eval()
        card = copy.deepcopy(cpu).to(cuda)

        def run(model, inp):
            return zoedepth_infer(model, inp, attn_impl="fused" if inp.is_cuda else "xla")
    else:
        cpu = MidasDPT(MidasDPTConfig(embed_dim=128, depth=4, num_heads=2, hooks=(0, 1, 2, 3),
                                      img_size=64, **dpt)).init_weights(gen).eval()
        with torch.no_grad():
            cpu.scratch.output_conv[4].bias.fill_(0.1)  # a depth that is not all 0
        card = copy.deepcopy(cpu).to(cuda)

        def run(model, inp):
            return model(inp, attn_impl="fused" if inp.is_cuda else "xla")[0]
    before, before_bias = tatt.KERNEL.launches, tatt.KERNEL.bias_launches
    with torch.no_grad():
        got = run(card, x.to(cuda)).cpu()
        ref = run(cpu, x)
    assert tatt.KERNEL.launches == before + (8 if model_name == "zoedepth" else 4)
    assert tatt.KERNEL.bias_launches == before_bias + (8 if model_name == "zoedepth" else 0)
    assert float(ref.abs().max()) > 0
    assert float((got - ref).norm() / ref.norm()) <= 1e-4


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_at_the_train_shape(cuda, dtype):
    """B=32, N=785 (224 px): 12 x 64 + 17 rows, so a ragged sub-tile inside a
    ragged 256-row block, and 6 x 128 + 17 keys."""
    gen = torch.Generator().manual_seed(4)
    qkv = torch.randn(32, 785, 3 * 384, generator=gen).to(cuda, dtype)
    before = tatt.KERNEL.launches
    out = tatt.attention_qkv(qkv, 6, 0.125)
    torch.cuda.synchronize()
    assert tatt.KERNEL.launches == before + 1
    q, k, v = tatt.split_qkv(qkv, 6)
    ref = tatt.attention_plain(q, k, v, 0.125).permute(0, 2, 1, 3)
    _assert_close(out, ref.reshape(out.shape), dtype)


@pytest.mark.parametrize("case", ["generic", "constant", "duplicated_rows", "plateaus"])
def test_fps_card_vs_cpu(cuda, case):
    """Depth FPS picks the same coordinates on the card as on the CPU, also
    where candidates tie exactly: a constant depth map, a map whose rows
    repeat, and a map of a few flat plateaus (``argmax`` takes the first
    maximal index on both). The generic case uses seeded smooth depths."""
    from depthg_tpu_torch.ops.depth import farthest_point_sampling_depth, fps_indices

    gen = torch.Generator().manual_seed(5)
    b, hw, s = 6, 28, 11
    if case == "generic":  # pooled from 224 px, as the train step does
        low = torch.rand(b, 1, 28, 28, generator=gen)
        depth = torch.nn.functional.interpolate(low, size=(224, 224), mode="bilinear")
    elif case == "constant":  # the tie cases at the grid's own size: no pooling
        depth = torch.full((b, 1, hw, hw), 0.37)
    elif case == "duplicated_rows":
        depth = torch.rand(b, 1, 1, hw, generator=gen).expand(b, 1, hw, hw).contiguous()
    else:
        depth = torch.randint(0, 3, (b, 1, 4, 4), generator=gen).float() \
            .repeat_interleave(7, 2).repeat_interleave(7, 3)
    grid = torch.zeros(b, 1, hw, hw)
    on_cpu = farthest_point_sampling_depth(grid, depth, s)
    on_card = farthest_point_sampling_depth(grid.to(cuda), depth.to(cuda), s)
    assert on_card.shape == (b, s, s, 2)
    assert torch.equal(on_card.cpu(), on_cpu)
    if case == "constant":
        # every distance ties at every step of a flat cloud's first row
        pts = torch.ones(40, 3)
        assert fps_indices(pts.to(cuda), 7).tolist() == fps_indices(pts, 7).tolist() == list(range(7))


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_train_step_card_vs_cpu(cuda, impl):
    """One float32 train step (ViT-S/8 cut to 2 blocks, 224 px, batch 4,
    dropout off, fixed coordinates and permutations) on the card vs the CPU
    from the same weights: every logged loss within 1e-4 relative (plus
    1e-6 absolute) and every gradient within 1e-4 of its tensor's largest
    entry. ``grid_sample``'s backward sums with atomics on the card, so the
    gradients differ from run to run by float32 rounding; the parameters
    after the step are not compared, since Adam's first update is
    +-lr whatever a gradient's size."""
    import copy
    import dataclasses

    from depthg_tpu_torch import inference, profile_train
    from depthg_tpu_torch.models import featurizer, vit
    from depthg_tpu_torch.ops.depth import farthest_point_sampling_depth
    from depthg_tpu_torch.train import losses as loss_lib
    from depthg_tpu_torch.train import step as step_lib

    b = 4
    fcfg = featurizer.FeaturizerConfig(
        vit_config=dataclasses.replace(vit.make_config("vit_small", 8), depth=2),
        dropout=False, drop_rate=0.0)
    lcfg = loss_lib.CorrLossConfig()
    gen = torch.Generator().manual_seed(6)
    model = inference.Segmenter(fcfg, 27, 27, decoder=True).init_weights(gen)
    batch = profile_train.synthetic_batch(b, 224, 27, gen)
    perms = torch.stack([torch.randperm(b, generator=gen) for _ in range(5)])
    both = farthest_point_sampling_depth(
        torch.zeros(2 * b, 1, 28, 28), torch.cat([batch["depth"], batch["depth_pos"]]), 11) * 2 - 1
    coords = (both[:b], both[b:])
    hp_cpu = step_lib.TrainHParams(n_classes=27, precision="float32")
    hp = hp_cpu if impl == "eager" else dataclasses.replace(hp_cpu, precision=None)
    ref_state = step_lib.state_from_model(copy.deepcopy(model), hp_cpu)
    ref = step_lib.train_step(ref_state, batch, hp_cpu, lcfg, 0.19, 0.03,
                              coords_override=coords, neg_perms=perms)
    state = step_lib.state_from_model(copy.deepcopy(model).to(cuda), hp)
    before = tatt.KERNEL.launches
    logs = step_lib.train_step(state, {k: v.to(cuda) for k, v in batch.items()}, hp, lcfg,
                               0.19, 0.03, coords_override=tuple(c.to(cuda) for c in coords),
                               neg_perms=perms.to(cuda))
    assert tatt.KERNEL.launches - before == (4 if impl == "kernel" else 0)
    assert sorted(logs) == sorted(ref)
    for name in ref:
        torch.testing.assert_close(logs[name].cpu(), ref[name], rtol=1e-4, atol=1e-6, msg=name)
    for (name, p), q in zip(state.model.named_parameters(), ref_state.model.parameters()):
        assert (p.grad is None) == (q.grad is None), name
        if q.grad is not None:
            scale = float(q.grad.abs().max())
            assert float((p.grad.cpu() - q.grad).abs().max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("dtype,b,n", [(torch.bfloat16, 1, 1601), (torch.bfloat16, 2, 1601),
                                       (torch.bfloat16, 4, 1601), (torch.bfloat16, 8, 1601),
                                       (torch.bfloat16, 32, 1601), (torch.float32, 128, 785)])
def test_attention_kernel_at_the_serving_and_knn_shapes(cuda, dtype, b, n):
    """The batches the serving buckets give the kernel (b images, or 2b under
    the stacked TTA forward; B=1 is 42 blocks on 132 SMs) and the float32
    batch of the KNN embedding (128 images at 224 px)."""
    gen = torch.Generator().manual_seed(7)
    qkv = torch.randn(b, n, 3 * 384, generator=gen).to(cuda, dtype)
    before = tatt.KERNEL.launches
    out = tatt.attention_qkv(qkv, 6, 0.125)
    torch.cuda.synchronize()
    assert tatt.KERNEL.launches == before + 1
    q, k, v = tatt.split_qkv(qkv, 6)
    ref = tatt.attention_plain(q, k, v, 0.125).permute(0, 2, 1, 3)
    _assert_close(out, ref.reshape(out.shape), dtype)


@pytest.mark.parametrize("fused_tta", [True, False])
def test_service_round_trip_on_the_card(cuda, tmp_path, fused_tta):
    """A ViT-S/8 cut to 2 blocks, exported as a ``.ckpt`` and served through
    ``build_service`` at 128 px over HTTP: three images posted at once come
    back each equal to the predict step on the padded batch they rode in,
    through the attention kernel on the dispatcher thread (2 or 4 launches
    per batch) and without a launch of the bilateral kernel."""
    import dataclasses
    import io
    import threading
    import urllib.request

    import numpy as np
    from PIL import Image

    from depthg_tpu_torch import inference, serve
    from depthg_tpu_torch.config import load_config
    from depthg_tpu_torch.models import featurizer, vit
    from depthg_tpu_torch.profile_serve import synthetic_jpeg
    from depthg_tpu_torch.utils.checkpoint_io import load_segmenter
    from depthg_tpu_torch.utils.ckpt import export_lightning_ckpt

    fcfg = featurizer.FeaturizerConfig(
        vit_config=dataclasses.replace(vit.make_config("vit_small", 8), depth=2))
    model = inference.Segmenter(fcfg, 27, 27).init_weights(torch.Generator().manual_seed(8))
    ckpt = str(tmp_path / "seg.ckpt")
    export_lightning_ckpt(ckpt, model.state_dict(), cfg={"model_type": "vit_small", "dim": 70})
    cfg = load_config("serve_config.yml", [f"model_path={ckpt}", "res=128", "max_batch=4",
                                           "max_wait_ms=500", f"fused_tta={fused_tta}"])
    # build_service would read the depth from the run config's model_type, so
    # the cut model is loaded here and handed to the service with the config's settings
    sd, run_cfg = load_segmenter(ckpt)
    model = inference.Segmenter.from_state_dict(sd, fcfg)
    ecfg = inference.ecfg_from_checkpoint(cfg, sd, run_cfg)
    svc = serve.SegmentationService(model, ecfg, res=128, max_batch=4, max_wait_ms=500.0,
                                    device=cuda)
    seen = []
    run_batch = svc.batcher._run_batch
    svc.batcher._run_batch = lambda items: (seen.append(list(items)), run_batch(items))[1]
    server = serve.serve_http(svc, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert svc.warmup() == [1, 2, 4]
        bodies = [synthetic_jpeg(20 + i, 200, 160) for i in range(3)]
        outs = [None] * 3

        def post(i):
            req = urllib.request.Request(f"{base}/v1/segment?format=npz", data=bodies[i],
                                         method="POST")
            outs[i] = np.load(io.BytesIO(urllib.request.urlopen(req, timeout=120).read()))

        k1, k4 = tatt.KERNEL.launches, tbil.KERNEL.launches
        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert all(o is not None for o in outs)
        per_batch = 2 if fused_tta else 4
        assert tatt.KERNEL.launches - k1 == per_batch * len(seen)
        assert tbil.KERNEL.launches == k4
        arrs = [np.asarray(svc._transform(Image.open(io.BytesIO(b)).convert("RGB")), np.float32)
                for b in bodies]
        predict = inference.make_predict_step(ecfg)
        matched = 0
        for items in seen:
            b = serve._bucket(len(items), 4)
            padded = torch.from_numpy(np.stack(items + [items[0]] * (b - len(items)))).to(cuda)
            lin, clu = (p.cpu().numpy() for p in predict(svc._model, padded))
            for row, item in enumerate(items):
                (i,) = [j for j, a in enumerate(arrs) if np.array_equal(a, item)]
                np.testing.assert_array_equal(outs[i]["linear"], lin[row])
                np.testing.assert_array_equal(outs[i]["cluster"], clu[row])
                matched += 1
        assert matched == 3 and outs[0]["cluster"].shape == (128, 128)
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_topk_neighbors_on_the_card(cuda, monkeypatch):
    """Both branches on the card against float64 (index-exact but for
    near-ties), the default bf16 product returning float32 similarities
    (self at rank 0), and TF32 still off."""
    import numpy as np

    from depthg_tpu_torch import runtime
    from depthg_tpu_torch.parallel import knn

    gen = torch.Generator().manual_seed(9)
    feats = torch.nn.functional.normalize(torch.randn(5000, 64, generator=gen), dim=1)
    f64 = feats.double()
    sims = f64 @ f64.t()
    ref = sims.topk(10, dim=1).indices
    one_pass = knn.topk_neighbors(feats, k=10, precision="highest", device=cuda)
    monkeypatch.setattr(knn, "_KEY_BLOCK", 1024)
    blocked = knn.topk_neighbors(feats, k=10, precision="highest", device=cuda)
    low = knn.topk_neighbors(feats, k=10, device=cuda)
    for out in (one_pass, blocked):
        assert out.dtype == np.int32 and out.shape == (5000, 10)
        got = torch.from_numpy(out).long()
        gap = (sims.gather(1, got) - sims.gather(1, ref)).abs()
        assert float(gap.max()) <= 1e-6
    assert (low[:, 0] == np.arange(5000)).all()
    assert float((torch.from_numpy(low).long() == ref).float().mean()) > 0.9
    assert runtime.tf32_off()


# ---------------------------------------------------------------- float32 bodies (split TF32)


def _f32_attention_case(b, n, heads, n_valid, seed):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3 * 64 * heads, generator=gen)
    qkv[:, n_valid:] = 0.0
    return qkv


@pytest.mark.parametrize("b,n,n_valid", [(2, 1, 1), (2, 77, 77), (2, 769, 769), (2, 785, 785),
                                         (2, 1601, 1601), (2, 1664, 1601), (3, 785, 700)])
def test_attention_f32_kernel_matches_plain_and_emulation(cuda, b, n, n_valid):
    """The float32 kernel at one key (N=1), a short N, the ZoeDepth, train/KNN
    and eval N, and n_valid < N: against the plain version and against the
    emulation of its own arithmetic; padded rows exactly 0."""
    qkv = _f32_attention_case(b, n, 6, n_valid, seed=n).to(cuda)
    before, before_f32 = tatt.KERNEL.launches, tatt.KERNEL.f32_launches
    out = tatt.attention_qkv(qkv, 6, 0.125, n_valid)
    torch.cuda.synchronize()
    assert tatt.KERNEL.launches == before + 1 and tatt.KERNEL.f32_launches == before_f32 + 1
    q, k, v = tatt.split_qkv(qkv, 6)
    ref = tatt.attention_plain(q, k, v, 0.125, n_valid).permute(0, 2, 1, 3).reshape(out.shape)
    _assert_close(out, ref, torch.float32)
    emu = emulate_attention(q, k, v, 0.125, n_valid).permute(0, 2, 1, 3).reshape(out.shape)
    _assert_close(out, emu, torch.float32)
    assert torch.all(out[:, n_valid:] == 0)


def test_attention_f32_kernel_strided_operands_and_inf_past_n_valid(cuda):
    """q, k and v as views of three larger buffers (other batch, head and row
    strides than the packed layout), inf in k and v past n_valid and NaN in
    the buffers' unused rows: read through their strides, nothing past
    n_valid has influence."""
    gen = torch.Generator().manual_seed(31)
    bufs = [torch.randn(3, 8, 800, 64, generator=gen).to(cuda) for _ in range(3)]
    for t in bufs:
        t[:, :, 770:] = float("nan")
    q, k, v = (t[:2, 1:7, :769] for t in bufs)
    out = torch.empty(2, 6, 769, 64, device=cuda)
    tatt._launch(q, k, v, out, 0.125, 700)
    ref = tatt.attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), 0.125, 700)
    _assert_close(out, ref, torch.float32)
    _assert_close(out, emulate_attention(q, k, v, 0.125, 700), torch.float32)
    k[:, :, 700:] = float("inf")
    v[:, :, 700:] = float("inf")
    again = torch.empty_like(out)
    tatt._launch(q, k, v, again, 0.125, 700)
    torch.cuda.synchronize()
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    assert torch.all(out[:, :, 700:] == 0)


@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_attention_f32_kernel_with_bias_n_valid_700(cuda, bias_dtype):
    """float32 q/k/v with BEiT's [16, 769, 769] bias in either dtype at
    n_valid=700: plain version and emulation."""
    qkv = _f32_attention_case(2, 769, 16, 700, seed=41).to(cuda)
    bias = _padded_bias(16, 769, bias_dtype, 42, scale=2.0)
    before = tatt.KERNEL.bias_launches
    out = tatt.attention_qkv(qkv, 16, 0.125, 700, bias=bias)
    torch.cuda.synchronize()
    assert tatt.KERNEL.bias_launches == before + 1
    q, k, v = tatt.split_qkv(qkv, 16)
    ref = tatt.attention_plain(q, k, v, 0.125, 700, bias=bias).permute(0, 2, 1, 3)
    _assert_close(out, ref.reshape(out.shape), torch.float32)
    emu = emulate_attention(q, k, v, 0.125, 700, bias).permute(0, 2, 1, 3)
    _assert_close(out, emu.reshape(out.shape), torch.float32)
    assert torch.all(out[:, 700:] == 0)


def test_attention_workspace_sizes(cuda):
    """The float32 entry's workspace: 64 KB per key tile of 64 per (image,
    head); none for bf16."""
    fns = tatt.KERNEL.fn()
    assert fns.workspace_bytes(128, 6, 785, 0) == 128 * 6 * 13 * 65536
    assert fns.workspace_bytes(2, 16, 700, 0) == 2 * 16 * 11 * 65536
    assert fns.workspace_bytes(16, 6, 1601, 1) == 0


@pytest.mark.parametrize("c", [1, 8, 27, 54, 70])
def test_bilateral_f32_kernel_matches_plain_and_emulation(cuda, c):
    """The split-TF32 float32 message at every channel count the CRF uses
    (C = 70: a second channel chunk), N=1000 (a ragged key tile)."""
    feats, values = _bilateral_inputs(2, 1000, c, torch.float32, seed=c)
    feats, values = feats.to(cuda), values.to(cuda)
    before, before_f32 = tbil.KERNEL.launches, tbil.KERNEL.f32_launches
    out = tbil.bilateral_message(feats, values)
    torch.cuda.synchronize()
    assert tbil.KERNEL.launches == before + 1 and tbil.KERNEL.f32_launches == before_f32 + 1
    _assert_k4_close(out, tbil.bilateral_message_plain(feats, values), torch.float32)
    _assert_k4_close(out, emulate_bilateral(feats, values), torch.float32)


def test_bilateral_f32_kernel_ragged_scene_size(cuda):
    """N = 25,563 (the ds=2 scene size with a ragged edge), C=54, through
    views of buffers that are NaN past N: plain version and emulation, and
    nothing written past N."""
    n, pad = 25_563, 37
    feats, values = _bilateral_inputs(1, n + pad, 54, torch.float32, seed=5)
    feats[..., :2] *= 12.0  # positions over ~60 sigmas, like a 160 x 160 grid
    feats, values = feats.to(cuda), values.to(cuda)
    ref = tbil.bilateral_message_plain(feats[:, :n].contiguous(), values[:, :n].contiguous())
    emu = emulate_bilateral(feats[:, :n], values[:, :n])
    feats[:, n:], values[:, n:] = float("nan"), float("nan")
    out = torch.full_like(values, 7.0)
    tbil._launch(feats[:, :n], values[:, :n], out[:, :n])
    torch.cuda.synchronize()
    _assert_k4_close(out[:, :n], ref, torch.float32)
    _assert_k4_close(out[:, :n], emu, torch.float32)
    assert torch.all(out[:, n:] == 7.0)


# The fine-tune slice (ZoeDepth fine-tuning and ZoeDepth-NK).

def test_attention_kernel_refuses_a_gradient_it_cannot_give(cuda):
    """The kernel has no backward: with gradients on, a ``qkv`` or bias that
    requires a gradient is refused before any launch (not returned without
    a ``grad_fn``); under ``no_grad``, and with frozen inputs while
    gradients are on, it launches."""
    qkv = torch.randn(1, 77, 3 * 128, device=cuda, requires_grad=True)
    bias = _padded_bias(2, 77, torch.float32, 51)
    before = tatt.KERNEL.launches
    with pytest.raises(RuntimeError, match="no backward"):
        tatt.attention_qkv(qkv, 2, 0.125)
    with pytest.raises(RuntimeError, match="xla"):
        tatt.attention_qkv(qkv.detach(), 2, 0.125, bias=bias.clone().requires_grad_(True))
    assert tatt.KERNEL.launches == before
    with torch.no_grad():
        out = tatt.attention_qkv(qkv, 2, 0.125, bias=bias)
    frozen = tatt.attention_qkv(qkv.detach(), 2, 0.125, bias=bias)
    torch.cuda.synchronize()
    assert tatt.KERNEL.launches == before + 2
    assert not frozen.requires_grad
    torch.testing.assert_close(frozen, out, rtol=0, atol=0)


def test_attention_f32_kernel_with_bias_at_the_finetune_shape(cuda):
    """float32 q/k/v with BEiT-L's bias at NYU's 480 x 640 (N = 30 x 40 + 1 =
    1201, not a multiple of 8: the bias is a [:, :, :1201] view of [16,
    1201, 1208]), one image as the fine-tune's validation runs it: the
    plain version at the float32 limits."""
    qkv = _f32_attention_case(1, 1201, 16, 1201, seed=52).to(cuda)
    bias = _padded_bias(16, 1201, torch.float32, 53, scale=2.0)
    assert bias.stride() == (1201 * 1208, 1208, 1)
    before = (tatt.KERNEL.bias_launches, tatt.KERNEL.f32_launches)
    out = tatt.attention_qkv(qkv, 16, 0.125, bias=bias)
    torch.cuda.synchronize()
    assert (tatt.KERNEL.bias_launches, tatt.KERNEL.f32_launches) == (before[0] + 1, before[1] + 1)
    q, k, v = tatt.split_qkv(qkv, 16)
    ref = tatt.attention_plain(q, k, v, 0.125, bias=bias).permute(0, 2, 1, 3)
    _assert_close(out, ref.reshape(out.shape), torch.float32)


def _small_zoe(gen):
    """ZoeDepth with a 4-block, 128-wide BEiT (2 heads of 64, so the kernel
    takes it), LayerScale 0.1, float32."""
    from depthg_tpu_torch.models.zoedepth import ZoeConfig, ZoeDepth
    from depthg_tpu_torch.models.zoedepth.beit import BEiTConfig
    from depthg_tpu_torch.models.zoedepth.dpt import DPTConfig

    return ZoeDepth(ZoeConfig(
        n_bins=16, bin_embedding_dim=16, img_size=(96, 128),
        beit=BEiTConfig(embed_dim=128, depth=4, num_heads=2, pretrain_window=4,
                        hooks=(0, 1, 2, 3), layer_scale_init=0.1),
        dpt=DPTConfig(embed_dim=128, features=32, reassemble_channels=(16, 32, 64, 64)))
    ).init_weights(gen)


def test_finetune_step_card_vs_cpu(cuda):
    """One float32 fine-tune step of a small ZoeDepth on the card (eager
    attention: no launch) vs the CPU from the same weights: the loss and
    every gradient within 1e-4 relative (gradients before the clip, held by
    norm per tensor); then a validation forward on the card goes through
    the kernel with the bias (4 launches) and agrees with the CPU's."""
    import copy

    from depthg_tpu_torch.models.zoedepth import finetune

    gen = torch.Generator().manual_seed(61)
    cpu = _small_zoe(gen)
    card = copy.deepcopy(cpu).to(cuda)
    batch = {"image": torch.rand(2, 3, 96, 128, generator=gen),
             "depth": torch.rand(2, 1, 96, 128, generator=gen) * 8 + 0.5,
             "mask": torch.rand(2, 1, 96, 128, generator=gen) > 0.2}
    cfg = finetune.FinetuneConfig(total_steps=4)
    before = tatt.KERNEL.launches
    losses = {}
    for name, model in (("card", card), ("cpu", cpu)):
        dev = next(model.parameters()).device
        loss, _ = finetune.finetune_loss(model, {k: v.to(dev) for k, v in batch.items()}, cfg)
        loss.backward()
        losses[name] = float(loss.detach())
    assert tatt.KERNEL.launches == before
    assert abs(losses["card"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        if p.grad is None:
            assert q.grad is None, name
            continue
        ref = p.grad.double()
        assert float((q.grad.cpu().double() - ref).norm()) <= 1e-4 * max(float(ref.norm()),
                                                                         1e-30), name
    with torch.no_grad():
        got = card(batch["image"][:1].to(cuda), attn_impl="auto")["metric_depth"].cpu()
        ref = cpu(batch["image"][:1])["metric_depth"]
    assert tatt.KERNEL.launches == before + 4
    assert float((got - ref).norm() / ref.norm()) <= 1e-4


def test_small_zoedepth_nk_card_vs_cpu(cuda):
    """A small ZoeDepth-NK (the BEiT above) in float32 on the card through
    the kernel with the bias vs the CPU: the same domain, metric depth
    within 1e-4 relative."""
    import copy

    from depthg_tpu_torch.models.zoedepth import nk

    gen = torch.Generator().manual_seed(71)
    base = _small_zoe(torch.Generator().manual_seed(0)).cfg
    cfg = nk.ZoeNKConfig(bin_confs=(nk.BinConf("nyu", 16, 1e-3, 10.0),
                                    nk.BinConf("kitti", 16, 1e-3, 80.0)),
                         bin_embedding_dim=16, router_dim=16, router_heads=2, router_layers=2,
                         beit=base.beit, dpt=base.dpt)
    cpu = nk.ZoeDepthNK(cfg).init_weights(gen).eval()
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.rand(2, 3, 96, 128, generator=gen)
    before = tatt.KERNEL.bias_launches
    with torch.no_grad():
        got = card(x.to(cuda))
        ref = cpu(x)
    assert tatt.KERNEL.bias_launches == before + 4
    assert nk.domain_index(got["domain_logits"].cpu()) == nk.domain_index(ref["domain_logits"])
    depth = got["metric_depth"].cpu()
    assert float((depth - ref["metric_depth"]).norm() / ref["metric_depth"].norm()) <= 1e-4


def _lhp_affinity_card_vs_cpu(depth_cpu, device):
    """The LHP depth affinity on the card and on the CPU from one float32
    depth batch: (flips, their distance to the threshold, the largest
    difference elsewhere)."""
    from depthg_tpu_torch.models import lhp

    hw = (depth_cpu.shape[-2] // 8, depth_cpu.shape[-1] // 8)
    ref = lhp._depth_affinity(depth_cpu, hw, False)
    out = lhp._depth_affinity(depth_cpu.to(device), hw, False).cpu()
    normed, thresh = lhp._depth_normed(depth_cpu, hw, False)
    flips = (out == 0) != (ref == 0)
    gap = (normed - thresh).abs()[flips]
    return flips, gap, float((out - ref)[~flips].abs().max())


def test_lhp_depth_affinity_card_vs_cpu(cuda):
    """B=4 at 224 px (784 points), float32 with TF32 off: the zero pattern
    equal but for flips next to the threshold (within 2e-3 in the
    normalized distance, the expansion's rounding), values within 2e-3; the
    LHP-mixed code within 1e-5 relative."""
    from depthg_tpu_torch.models import lhp

    gen = torch.Generator().manual_seed(0)
    low = torch.rand(4, 1, 28, 28, generator=gen)
    depth = torch.nn.functional.interpolate(low, size=(224, 224), mode="bilinear")
    assert not torch.backends.cuda.matmul.allow_tf32
    flips, gap, worst = _lhp_affinity_card_vs_cpu(depth, cuda)
    assert bool((gap <= 2e-3).all()) and int(flips.sum()) <= 1e-5 * flips.numel()
    assert worst <= 2e-3
    head = lhp.LHP(lhp.LHPConfig(dim=70)).init_weights(torch.Generator().manual_seed(1))
    code = torch.randn(4, 70, 28, 28, generator=gen)
    ref = lhp.lhp_apply(head, code, depth)
    out = lhp.lhp_apply(head.to(cuda), code.to(cuda), depth.to(cuda)).cpu()
    assert float((out - ref).norm() / ref.norm()) <= 1e-5


def test_dino_depth_step_launches_k1_24_times(cuda):
    """One ``arch=dino_depth`` (cross_attn) train step at full ViT-S/8 width
    (2 blocks here) launches the attention kernel once per block and
    forward: 2 x blocks; the cross-attention (8 heads of 48) stays eager."""
    from depthg_tpu_torch.models.featurizer_depth import DepthFeaturizerConfig
    from depthg_tpu_torch.models.vit import ViTConfig
    from depthg_tpu_torch.train import losses, step

    fcfg = DepthFeaturizerConfig(guidance="cross_attn", vit_config=ViTConfig(depth=2))
    hp = step.TrainHParams(n_classes=27, backbone_dtype="bfloat16")
    state = step.init_state(fcfg, hp, torch.Generator().manual_seed(0), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {"img": torch.randn(4, 3, 224, 224, device=cuda, generator=gen),
             "img_pos": torch.randn(4, 3, 224, 224, device=cuda, generator=gen),
             "label": torch.randint(-1, 27, (4, 224, 224), device=cuda, generator=gen),
             "depth": torch.rand(4, 1, 224, 224, device=cuda, generator=gen),
             "depth_pos": torch.rand(4, 1, 224, 224, device=cuda, generator=gen)}
    before = tatt.KERNEL.launches
    logs = step.train_step(state, batch, hp, losses.CorrLossConfig(), 0.19, 0.03, generator=gen)
    torch.cuda.synchronize()
    assert tatt.KERNEL.launches - before == 2 * 2
    assert all(bool(torch.isfinite(v).all()) for v in logs.values())


def test_pyramid_bf16_vs_float32_on_the_card(cuda):
    """The pyramid's ResNet-50 in bf16 against float32 on the card (code
    correlation above 0.99, features float32), and the float32 pyramid on
    the card against the CPU within 1e-4 relative."""
    from depthg_tpu_torch.models import featurizer, pyramid

    net = pyramid.FeaturePyramidNet(pyramid.PyramidConfig(granularity=4))
    net.init_weights(torch.Generator().manual_seed(0))
    img = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = featurizer.dispatch_apply(net, img)["code"]
        net = net.to(cuda)
        out32 = featurizer.dispatch_apply(net, img.to(cuda))["code"]
        out16 = featurizer.dispatch_apply(net, img.to(cuda), backbone_dtype="bfloat16")["code"]
    assert out16.dtype == torch.float32
    assert float((out32.cpu() - ref).norm() / ref.norm()) <= 1e-4
    corr = torch.corrcoef(torch.stack([out32.flatten(), out16.flatten()]))[0, 1]
    assert float(corr) > 0.99


@pytest.mark.parametrize("arch,kw", [
    ("dino_depth", {"guidance": "none"}),
    *[("feature-pyramid", {"granularity": g, "continuous": c})
      for g in (1, 2, 3, 4) for c in (True, False)],
])
def test_variant_train_and_eval_steps_on_the_card(cuda, arch, kw):
    """The variants the smoke run does not time, on the card: one train step
    (finite logs, the frozen backbone untouched, K1 24 times for the ViT
    and never for the ResNet) and one eval step at the default CRF point
    (confusion sums equal to the labelled pixels)."""
    from depthg_tpu_torch import inference
    from depthg_tpu_torch.models.featurizer_depth import DepthFeaturizerConfig
    from depthg_tpu_torch.models.pyramid import PyramidConfig
    from depthg_tpu_torch.models.vit import ViTConfig
    from depthg_tpu_torch.train import losses, step

    fcfg = (DepthFeaturizerConfig(vit_config=ViTConfig(depth=2), **kw) if arch == "dino_depth"
            else PyramidConfig(**kw))
    hp = step.TrainHParams(n_classes=27, backbone_dtype="bfloat16")
    state = step.init_state(fcfg, hp, torch.Generator().manual_seed(0), device=cuda)
    frozen = {k: v.clone() for k, v in state.model.net.model.state_dict().items()}
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {"img": torch.randn(2, 3, 224, 224, device=cuda, generator=gen),
             "img_pos": torch.randn(2, 3, 224, 224, device=cuda, generator=gen),
             "label": torch.randint(-1, 27, (2, 224, 224), device=cuda, generator=gen),
             "depth": torch.rand(2, 1, 224, 224, device=cuda, generator=gen),
             "depth_pos": torch.rand(2, 1, 224, 224, device=cuda, generator=gen)}
    before = tatt.KERNEL.launches
    logs = step.train_step(state, batch, hp, losses.CorrLossConfig(feature_samples=5,
                                                                   neg_samples=2),
                           0.19, 0.03, generator=gen)
    torch.cuda.synchronize()
    assert tatt.KERNEL.launches - before == (4 if arch == "dino_depth" else 0)
    assert all(bool(torch.isfinite(v).all()) for v in logs.values())
    for k, v in state.model.net.model.state_dict().items():
        assert torch.equal(v, frozen[k]), k
    ecfg = inference.EvalConfig(n_classes=27, crf=tcrf.crf_config_from_cfg({}),
                                backbone_dtype="bfloat16", label_res=224)
    lin, clu = inference.make_eval_step(ecfg)(state.model, batch["img"], batch["label"])
    counted = int(((batch["label"] >= 0) & (batch["label"] < 27)).sum())
    assert int(lin.sum()) == int(clu.sum()) == counted


def test_attention_from_two_threads_on_two_streams(cuda):
    """Two threads, each on its own stream, launch the kernel 50 times at
    once (as the service's replicas do): every output equals the same
    launch alone and ``KERNEL.launches`` counts all 100."""
    import threading

    gen = torch.Generator(device="cuda").manual_seed(5)
    qkvs = [torch.randn(8, 1601, 3 * 384, device=cuda, generator=gen).to(torch.bfloat16)
            for _ in range(2)]
    alone = [tatt.attention_qkv(q, 6, 64 ** -0.5) for q in qkvs]
    torch.cuda.synchronize()
    outs = [[], []]

    def run(i):
        stream = torch.cuda.Stream(cuda)
        with torch.cuda.stream(stream):
            for _ in range(50):
                outs[i].append(tatt.attention_qkv(qkvs[i], 6, 64 ** -0.5))
        stream.synchronize()

    before = tatt.KERNEL.launches
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tatt.KERNEL.launches - before == 100
    for i in range(2):
        for out in outs[i]:
            assert torch.equal(out, alone[i])


@pytest.mark.parametrize("m,k,n", [(25616, 384, 1152), (6152, 1024, 4096), (2048, 1536, 384),
                                   (5, 384, 384), (16, 1024, 1024), (17, 384, 1536)])
def test_w8a8_linear_on_card_equals_the_cpu(cuda, m, k, n):
    """Codes and scales (every scale divides by a tensor, as the CPU does)
    and the int32 sums equal; the bf16 output within one bf16 step (the
    rescale's float32 product may round apart)."""
    from depthg_tpu_torch.models import layers

    torch.manual_seed(m + k + n)
    lin = torch.nn.Linear(k, n)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(1)).bfloat16()
    q_cpu, q = layers.quantize_linear(lin), layers.quantize_linear(lin.to(cuda))
    for name in ("w_q", "s_w", "b"):
        assert torch.equal(getattr(q, name).cpu(), getattr(q_cpu, name)), name
    codes, s_x = layers.quantize_rows(x.to(cuda))
    codes_cpu, s_x_cpu = layers.quantize_rows(x)
    assert torch.equal(codes.cpu(), codes_cpu) and torch.equal(s_x.cpu(), s_x_cpu)
    rows = slice(0, 1024)
    assert torch.equal(layers.int8_matmul(codes, q.w_q)[rows].cpu(),
                       layers.int8_matmul(codes_cpu[rows], q_cpu.w_q))
    out = q(x.to(cuda))[rows].float().cpu()
    ref = q_cpu(x[rows]).float()
    assert out.shape == ref.shape
    assert bool(((out - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-6).all())


def test_w8a8_linear_refuses_widths_off_a_multiple_of_eight(cuda):
    from depthg_tpu_torch.models import layers

    q = layers.quantize_linear(torch.nn.Linear(36, 40).to(cuda))
    with pytest.raises(ValueError, match="multiples of 8"):
        q(torch.randn(32, 36, device=cuda))


def test_int8_vit_and_beit_on_card_match_the_cpu(cuda):
    """A 2-block ViT (128 wide, 2 heads) through ``backbone_features(...,
    "int8")`` and a 2-block BEiT through ``quantize_beit``, the card's
    kernels (K1 in bf16, with the bias for BEiT) against the CPU's plain
    path: cosine > 0.999 (bf16 roundings, codes flipping at .5)."""
    from depthg_tpu_torch.models import featurizer, vit
    from depthg_tpu_torch.models.zoedepth import beit

    def cos(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return float(a @ b / (a.norm() * b.norm()))

    fcfg = featurizer.FeaturizerConfig(vit_config=vit.ViTConfig(embed_dim=128, depth=2,
                                                                num_heads=2))
    net = featurizer.DinoFeaturizer(fcfg).init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    ref, _ = featurizer.backbone_features(net, x, backbone_dtype="int8")
    launches = tatt.KERNEL.launches
    out, _ = featurizer.backbone_features(net.to(cuda), x.to(cuda), backbone_dtype="int8")
    assert tatt.KERNEL.launches == launches + 2 and cos(out.cpu(), ref) > 0.999
    model = beit.BEiT(beit.BEiTConfig(embed_dim=128, depth=2, num_heads=2, pretrain_window=4,
                                      hooks=(0, 1), layer_scale_init=0.1))
    model.init_weights(torch.Generator().manual_seed(2))
    xb = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(3)).bfloat16()
    with torch.no_grad():
        ref, _ = beit.quantize_beit(model)(xb, attn_impl="xla")
        launches = tatt.KERNEL.bias_launches
        out, _ = beit.quantize_beit(model.to(cuda))(xb.to(cuda), attn_impl="fused")
    assert tatt.KERNEL.bias_launches == launches + 2
    for a, b in zip(out, ref):
        assert cos(a.float().cpu(), b.float()) > 0.999


# The contract sweep: K1 and K4 into output memory that held NaN
# (``test_torch_poison.poisoned``): an element a kernel leaves unwritten cannot
# pass by chance.

def _k1_contract(b, n, n_valid, heads, dtype, bias_dtype, seed=0):
    """K1 on poisoned output memory: rows >= n_valid exactly 0, rows below
    within TOL of ``attention_plain``, no NaN anywhere."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3 * 64 * heads, generator=gen).to("cuda", dtype)
    bias = None if bias_dtype is None else _padded_bias(heads, n, bias_dtype, seed + 1, 2.0)
    before = tatt.KERNEL.launches
    res = k1_contract(tatt, qkv, heads, n_valid, bias)
    assert tatt.KERNEL.launches == before + 1
    assert res["passes"], res


def _n_valid_cases(n):
    return sorted({v for v in (1, 64, 65, 128, 129, 255, 256, 257, n - 1, n) if 1 <= v <= n})


# (N, n_valid, heads): across the 64-row sub-tiles, the 256-row blocks and
# their second round of sub-tiles, the 128-key tiles and the float32
# kernel's 64-key tiles; 16 heads (BEiT-L, MiDaS) at N=769. The cases of
# fault F6 by name.
K1_SWEEP = ([pytest.param(n, nv, 2, id=f"n{n}_valid{nv}_h2")
             for n in (1, 64, 65, 128, 129, 256, 257, 384, 769, 785, 1201, 1664)
             for nv in _n_valid_cases(n)]
            + [pytest.param(769, nv, 16, id=f"n769_valid{nv}_h16")
               for nv in _n_valid_cases(769) if (769, nv, 16) not in F6_CASES]
            + [pytest.param(*case, id=f"F6_n{case[0]}_valid{case[1]}_h{case[2]}")
               for case in F6_CASES])
BIASES = pytest.mark.parametrize("bias_dtype", [None, torch.bfloat16, torch.float32],
                                 ids=["no_bias", "bf16_bias", "f32_bias"])
DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])


@BIASES
@DTYPES
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n,n_valid,heads", K1_SWEEP)
def test_attention_kernel_contract_on_poisoned_output(cuda, n, n_valid, heads, b, dtype,
                                                      bias_dtype):
    _k1_contract(b, n, n_valid, heads, dtype, bias_dtype)


# (B, N, n_valid, heads) at the grids the bias-free bf16 kernel chooses
# (``block_plan``): the serving buckets' B=1-8 at N=1601 with n_valid across
# the 128-row and 256-row block edges, and the narrow last key tiles (one
# warpgroup on the last block) of MiDaS (N=769), the train step (N=785) and
# NYU's 480 x 640 (N=1201)
K1_GRID_SWEEP = ([pytest.param(b, 1601, nv, 6, id=f"b{b}_n1601_valid{nv}_h6")
                  for b in (1, 2, 4, 8) for nv in (127, 128, 129, 1536, 1537, 1600, 1601)]
                 + [pytest.param(*case, id="b{}_n{}_valid{}_h{}".format(*case))
                    for case in ((8, 769, 769, 16), (8, 769, 641, 16), (32, 785, 785, 6),
                                 (32, 785, 721, 6), (1, 1201, 1201, 16), (4, 1201, 1153, 6))])


@BIASES
@DTYPES
@pytest.mark.parametrize("b,n,n_valid,heads", K1_GRID_SWEEP)
def test_attention_kernel_grid_contract_on_poisoned_output(cuda, b, n, n_valid, heads, dtype,
                                                           bias_dtype):
    _k1_contract(b, n, n_valid, heads, dtype, bias_dtype)


@pytest.mark.parametrize("b,n,n_valid,heads", [(2, 1601, 1601, 6), (2, 1601, 1537, 6),
                                               (1, 769, 769, 16), (3, 785, 721, 2),
                                               (2, 1201, 1201, 2), (1, 300, 129, 2)])
def test_attention_kernel_every_grid_on_poisoned_output(cuda, monkeypatch, b, n, n_valid, heads):
    """The bf16 kernel without a bias at every grid its C entry takes (256-row
    blocks per (image, head) from ceil(N / 256) down to 0, the rest 128-row
    blocks), each into memory that held NaN: rows >= n_valid exactly 0, the
    others within TOL of the plain version, and the bits of the grid
    ``block_plan`` chooses (every row walks the same key tiles in the same
    order)."""
    gen = torch.Generator().manual_seed(n + n_valid)
    qkv = torch.randn(b, n, 3 * 64 * heads, generator=gen).to(cuda, torch.bfloat16)
    q, k, v = tatt.split_qkv(qkv, heads)
    ref = tatt.attention_plain(q, k, v, 0.125, n_valid)
    chosen = tatt.attention_qkv(qkv, heads, 0.125, n_valid)

    def launch():
        out = torch.empty(b, n, heads, 64, device=cuda, dtype=torch.bfloat16)
        tatt._launch(q, k, v, out.permute(0, 2, 1, 3), 0.125, n_valid)
        return out

    for big in range(-(-n // 256) + 1):
        monkeypatch.setattr(tatt, "block_plan", lambda *args, big=big, **kwargs: big)
        before = tatt.KERNEL.launches
        out = poisoned(launch, (b, n, heads, 64), torch.bfloat16)
        torch.cuda.synchronize()
        assert tatt.KERNEL.launches == before + 1
        assert not torch.isnan(out).any(), big
        assert torch.all(out[:, n_valid:] == 0), big
        _assert_close(out[:, :n_valid].permute(0, 2, 1, 3), ref[:, :, :n_valid], torch.bfloat16)
        assert torch.equal(out.reshape(chosen.shape), chosen), big


@pytest.mark.parametrize("n,heads", [(1601, 6), (769, 16)])
def test_attention_kernel_batch_equals_image_by_image(cuda, n, heads):
    """Without a bias, a batch of 8 (256- and 128-row blocks, ``block_plan``)
    gives each image the bits it gets alone (at N=1601 on a grid of 128-row
    blocks only)."""
    gen = torch.Generator().manual_seed(n)
    qkv = torch.randn(8, n, 3 * 64 * heads, generator=gen).to(cuda, torch.bfloat16)
    out = tatt.attention_qkv(qkv, heads, 0.125)
    alone = torch.cat([tatt.attention_qkv(qkv[i:i + 1], heads, 0.125) for i in range(8)])
    torch.testing.assert_close(out, alone, rtol=0, atol=0)


@DTYPES
@pytest.mark.parametrize("c", [1, 8, 27, 54, 65])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 25_563])
def test_bilateral_kernel_contract_on_poisoned_output(cuda, n, c, dtype):
    """K4 across its 128-key (bf16) and 64-key (float32) tiles and 128-row
    blocks, C across the channel chunks: every element written, within
    its limits of ``bilateral_message_plain``."""
    b = 1 if n > 1000 else 2
    feats, values = _bilateral_inputs(b, n, c, dtype, seed=n + c)
    if n > 1000:
        feats[..., :2] *= 12.0  # positions over ~60 sigmas, like a 160 x 160 grid
    feats, values = feats.to(cuda), values.to(cuda)
    before = tbil.KERNEL.launches
    out = poisoned(lambda: tbil.bilateral_message(feats, values), (b, n, c), dtype)
    torch.cuda.synchronize()
    assert tbil.KERNEL.launches == before + 1
    assert not torch.isnan(out).any()
    _assert_k4_close(out, tbil.bilateral_message_plain(feats, values), dtype)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 25_563])
def test_bilateral_degree_contract_on_poisoned_output(cuda, n):
    """The degree entry (K @ 1) on poisoned output memory: every row written,
    within 5e-5 of the plain version on ones."""
    b = 1 if n > 1000 else 2
    feats, _ = _bilateral_inputs(b, n, 1, torch.float32, seed=n)
    if n > 1000:
        feats[..., :2] *= 12.0
    feats = feats.to(cuda)
    before = tbil.KERNEL.launches
    out = poisoned(lambda: tbil.bilateral_degree(feats), (b, n, 1), torch.float32)
    torch.cuda.synchronize()
    assert tbil.KERNEL.launches == before + 1
    assert not torch.isnan(out).any()
    ref = tbil.bilateral_message_plain(feats, torch.ones(b, n, 1, device=cuda))
    diff = out - ref
    assert (diff.norm() / ref.norm()).item() <= 5e-5
    assert diff.abs().max().item() <= 5e-5 * ref.abs().max().item()
