"""The float32 arithmetic of the Hopper kernels K1 (attention) and K4
(bilateral message), emulated on the CPU and held against the JAX package
and float64.

Both kernels multiply float32 operands on the tensor cores as split TF32
("3xTF32"): each operand x becomes hi + lo with hi = tf32(x) rounded to
nearest with ties away from zero, and each product is hi.hi + hi.lo + lo.hi
with float32 accumulation. The operands packed in memory (K1's k and v,
K4's values) take lo = tf32(x - hi), rounded the same way (PTX
``cvt.rna.tf32.f32``); the operands split in registers (K1's q and P, K4's
entries) take lo = x - hi, which the tensor cores read truncated to TF32.
The emulation here repeats that arithmetic:

* TF32 rounding by bit masks on an ``int32`` view;
* every ``wgmma`` k-step (8 products, exact in float64) added once onto
  its float32 accumulator and rounded toward zero, in the kernels' order:
  key tiles of 64, k-steps of 8, and per k-step hi.hi, hi.lo, lo.hi. The
  tensor cores truncate when they accumulate: a float32 sum carried over
  every key in the accumulator drifts toward zero by ~2^-25 per add (1.5e-5
  relative at N=1601 in this model, 1.2e-5 measured on an H100), so each
  key tile's products start from zero and are folded into the running sum
  on the CUDA cores, rounded to nearest;
* ``ex2.approx.ftz`` as exp2 in float64 off by 2^-22 relative (its 2-ulp
  error bound) with a sign taken from the argument's last bit, results
  below 2^-126 flushed to 0; a float32 FMA as float64 then rounded once;
* K1: q * scale in float32, the bias as the S accumulator's start, the
  online softmax per tile (``LOG2E`` FMA, ``ex2``), the tile's P V folded in
  as O * alpha + P V (one FMA), the row sum clamped at 1e-30 and applied as
  a reciprocal; keys >= n_valid weigh 0, rows >= n_valid are 0;
* K4: features times sqrt(log2(e) / 2) in float32 (as the pack step
  writes them), the distance as 5 float32 subtractions and 5 FMAs, the
  entry ex2(-|f_i - f_j|^2).

``tests/test_torch_cuda.py`` holds the kernels on the card to the same
functions (they run on CUDA tensors too), so this file imports JAX only
inside the comparisons. Limits: K1 max abs 1e-4 and relative ||out - ref|| /
||ref|| 1e-5 (the card's float32 limits, ``chip_smoke.TOL``); K4 relative
1e-5 and max abs 1e-5 of max |ref| (``K4_TOL``). Against JAX
``bilateral_message_pallas`` on fidelity-scene features the limit is the
JAX kernel's own error, 2e-3 (its log-kernel a.b - |a|^2/2 - |b|^2/2
cancels terms of ~2e4; ``tests/test_torch_crf_bilateral.py``); there the
emulation is held to float64 at 1e-5.
"""

import numpy as np
import pytest
import torch

from depthg_tpu_torch.crf_fidelity_study import make_scene


LOG2E = 1.4426950408889634
EX2_SCALE = 0.84932180028801907  # sqrt(log2(e) / 2)
KEY_TILE, K_STEP = 64, 8
ATT_TOL = (1e-4, 1e-5)  # max abs, relative
K4_LIMIT = 1e-5         # relative and max abs / max |ref|
SCENE_PALLAS_LIMIT = 2e-3


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero; NaN, inf and 0 pass through."""
    x = x.float().contiguous()
    bits = (x.view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by dropping the low 13 mantissa bits (what the tensor
    cores read of an operand that was not rounded first)."""
    x = x.float().contiguous()
    return torch.where(torch.isfinite(x), (x.view(torch.int32) & -0x2000).view(torch.float32), x)


def split_tf32(x: torch.Tensor, lo_rounded: bool = True):
    """x -> (hi, lo): lo rounded (packed operands) or truncated as the
    tensor cores read x - hi (operands split in registers)."""
    hi = tf32_round(x)
    return hi, (tf32_round if lo_rounded else tf32_truncate)(x.float() - hi)


def ex2_approx(x: torch.Tensor) -> torch.Tensor:
    """Model of ``ex2.approx.ftz.f32``: 2^x off by its 2-ulp bound."""
    x = x.float().contiguous()
    sign = 1 - 2 * (x.view(torch.int32) & 1).double()
    y = (torch.exp2(x.double()) * (1 + sign * 2.0 ** -22)).float()
    return y.masked_fill(y.abs() < 2.0 ** -126, 0.0)


def fma32(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def add_toward_zero(acc, x):
    """float32 acc + x (float64, exact), rounded toward zero."""
    s = acc.double() + x
    r = s.float()
    return torch.where(r.double().abs() > s.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _accumulate(acc, parts):
    """A tensor-core accumulator: acc (float32) += each k-step's float64 sum,
    truncated once per step; ``parts`` is [..., steps] per product, the
    products in kernel order."""
    for s in range(parts[0].shape[-1]):
        for p in parts:
            acc = add_toward_zero(acc, p[..., s])
    return acc


def emulate_attention(q, k, v, scale, n_valid=None, bias=None, fold_tiles=True):
    """K1's float32 kernel on [B, H, N, 64] q/k/v with an optional [H, N, N]
    bias -> [B, H, N, 64] float32. ``fold_tiles=False``: O carried in the
    tensor cores' accumulator over all tiles instead (the first version)."""
    b, h, n, hd = q.shape
    nv = n if n_valid is None else int(n_valid)
    dev = q.device
    keep = torch.arange(n, device=dev) < nv
    qh, ql = split_tf32((q.float() * scale).float(), lo_rounded=False)
    kh, kl = split_tf32(k.float().masked_fill(~keep[:, None], 0.0))
    vh, vl = split_tf32(v.float().masked_fill(~keep[:, None], 0.0))
    log2e = torch.tensor(LOG2E, dtype=torch.float32, device=dev)
    m = torch.full((b, h, n), float("-inf"), device=dev)
    l = torch.zeros((b, h, n), device=dev)
    acc = torch.zeros((b, h, n, hd), device=dev)

    def steps(x, axis_len):  # [..., L] -> [..., L / 8, 8] in float64
        return x.double().reshape(*x.shape[:-1], axis_len // K_STEP, K_STEP)

    for k0 in range(0, nv, KEY_TILE):
        k1 = min(k0 + KEY_TILE, n)
        kt = -(-(k1 - k0) // K_STEP) * K_STEP  # the tile's keys, padded to whole k-steps
        pad = kt - (k1 - k0)

        def keys(x):
            return torch.nn.functional.pad(x[:, :, k0:k1], (0, 0, 0, pad))

        if bias is None:
            s = torch.zeros((b, h, n, kt), device=dev)
        else:
            s = torch.nn.functional.pad(bias[:, :, k0:k1].float(), (0, pad))[None].expand(
                b, h, n, kt).contiguous()
        parts = [torch.einsum("bhnsd,bhmsd->bhnms", steps(a, hd), steps(keys(kk), hd))
                 for a, kk in ((qh, kh), (qh, kl), (ql, kh))]
        s = _accumulate(s, parts)
        in_tile = torch.arange(k0, k0 + kt, device=dev) < nv
        s = s.masked_fill(~in_tile, float("-inf"))
        mx = torch.maximum(m, s.amax(-1))
        alpha = ex2_approx((m - mx) * log2e)
        mlog = mx * log2e
        p = ex2_approx(fma32(s, log2e, -mlog[..., None]))
        l = fma32(l, alpha, p.sum(-1))
        ph, pl = split_tf32(p, lo_rounded=False)
        parts = [torch.einsum("bhnsk,bhskd->bhnds", steps(pp, kt),
                              keys(vv).double().reshape(b, h, kt // K_STEP, K_STEP, hd))
                 for pp, vv in ((ph, vh), (ph, vl), (pl, vh))]
        if fold_tiles:
            acc = fma32(acc, alpha[..., None], _accumulate(torch.zeros_like(acc), parts))
        else:
            acc = _accumulate(acc * alpha[..., None], parts)
        m = mx
    inv = 1.0 / torch.clamp(l, min=1e-30)
    return (acc * inv[..., None]).masked_fill(~keep[:, None], 0.0)


def emulate_bilateral(feats, values):
    """K4's float32 message: feats [B, N, 5], values [B, N, C] -> [B, N, C]."""
    b, n, _ = feats.shape
    c = values.shape[-1]
    dev = feats.device
    ft = (feats.float() * torch.tensor(EX2_SCALE, dtype=torch.float32)).float()
    zh, zl = split_tf32(values.float())
    out = torch.zeros((b, n, c), device=dev)
    for k0 in range(0, n, KEY_TILE):
        k1 = min(k0 + KEY_TILE, n)
        kt = -(-(k1 - k0) // K_STEP) * K_STEP
        pad = kt - (k1 - k0)
        d = torch.zeros((b, n, k1 - k0), device=dev)
        for f in range(5):
            a = ft[:, :, None, f] - ft[:, None, k0:k1, f]
            d = fma32(-a, a, d)
        # keys past n are the pack step's padding: entries 0, values 0
        p = torch.nn.functional.pad(ex2_approx(d), (0, pad))
        ph, pl = split_tf32(p, lo_rounded=False)
        zs = [torch.nn.functional.pad(z[:, k0:k1], (0, 0, 0, pad)).double().reshape(
            b, kt // K_STEP, K_STEP, c) for z in (zh, zl)]
        parts = [torch.einsum("bnsk,bskc->bncs", pp.double().reshape(b, n, kt // K_STEP, K_STEP),
                              zz) for pp, zz in ((ph, zs[0]), (ph, zs[1]), (pl, zs[0]))]
        out = out + _accumulate(torch.zeros_like(out), parts)
    return out


def attention_f64(q, k, v, scale, n_valid, bias=None):
    s = torch.einsum("bhnd,bhmd->bhnm", q.double() * scale, k.double())
    if bias is not None:
        s = s + bias.double()
    n = q.shape[2]
    keep = torch.arange(n) < n_valid
    s = s.masked_fill(~keep, float("-inf"))
    o = torch.softmax(s, -1) @ v.double().masked_fill(~keep[:, None], 0.0)
    return o.masked_fill(~keep[:, None], 0.0)


def bilateral_f64(feats, values):
    f = feats.double()
    d = ((f[:, :, None] - f[:, None]) ** 2).sum(-1)
    return torch.exp(-0.5 * d) @ values.double()


def assert_attention_close(out, ref, what=""):
    diff = out.double() - ref.double()
    err = diff.abs().max().item()
    rel = (diff.norm() / ref.double().norm()).item()
    assert err <= ATT_TOL[0] and rel <= ATT_TOL[1], f"{what}: max abs {err}, relative {rel}"


def assert_k4_close(out, ref, limit=K4_LIMIT, what=""):
    diff = out.double() - ref.double()
    rel = (diff.norm() / ref.double().norm()).item()
    err = diff.abs().max().item() / ref.double().abs().max().item()
    assert rel <= limit and err <= limit, f"{what}: relative {rel}, max abs / max |ref| {err}"


# ---------------------------------------------------------------- TF32 rounding


@pytest.mark.parametrize("x,nearest,truncated", [
    (1 + 2 ** -11, 1 + 2 ** -10, 1.0),                      # a tie: away from zero
    (1 + 2 ** -11 - 2 ** -23, 1.0, 1.0),                    # just below the tie
    (1 + 2 ** -10 + 2 ** -11, 1 + 2 ** -9, 1 + 2 ** -10),  # a tie above an odd last bit
    (-(1 + 2 ** -11), -(1 + 2 ** -10), -1.0),
    (3.0 - 2 ** -22, 3.0, 3.0 - 2 ** -9),
])
def test_tf32_round_to_nearest_vs_truncation(x, nearest, truncated):
    t = torch.tensor([x], dtype=torch.float32)
    assert tf32_round(t).item() == nearest
    assert tf32_truncate(t).item() == truncated


@pytest.mark.parametrize("lo_rounded", [True, False])
@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 85.0, 1e30])
def test_split_reconstructs_within_2_pow_minus_21(scale, lo_rounded):
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(100_000, generator=gen) * scale).float()
    hi, lo = split_tf32(x, lo_rounded)
    for part in (hi, lo):
        assert torch.all((part.view(torch.int32) & 0x1FFF) == 0)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert torch.all(err <= (2.0 ** -22 if lo_rounded else 2.0 ** -21) * x.double().abs())
    # truncation alone keeps ~10 bits; the split ~21
    assert (x.double() - tf32_truncate(x).double()).abs().max() > 2.0 ** -12 * x.abs().max()


def test_tf32_special_values_pass_through():
    x = torch.tensor([float("nan"), float("inf"), float("-inf"), 0.0, -0.0])
    for f in (tf32_round, tf32_truncate):
        y = f(x)
        assert torch.isnan(y[0]) and y[1].item() == float("inf") and y[2].item() == float("-inf")
        assert torch.equal(y[3:].view(torch.int32), x[3:].view(torch.int32))
    hi, lo = split_tf32(x[3:])
    assert torch.all(hi == 0) and torch.all(lo == 0)


def test_ex2_model_is_two_ulps_from_exp2():
    x = torch.linspace(-130.0, 10.0, 50_001)
    y = ex2_approx(x).double()
    ref = torch.exp2(x.double())
    big = ref >= 2.0 ** -126
    assert torch.all(((y - ref).abs() / ref)[big] <= 2.0 ** -22 + 2.0 ** -24)
    assert torch.all(y[~big] == 0)


# ---------------------------------------------------------------- K1


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode (they run on the CPU)."""
    from jax.experimental import pallas as pl

    import depthg_tpu.ops.attention as jatt
    import depthg_tpu.ops.crf_pallas as jpallas

    orig = pl.pallas_call
    patched = lambda *a, **k: orig(*a, **{**k, "interpret": True})  # noqa: E731
    monkeypatch.setattr(jatt.pl, "pallas_call", patched)
    monkeypatch.setattr(jpallas.pl, "pallas_call", patched)
    return jatt, jpallas


def _qkv_case(b, n, heads, n_valid, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * heads * 64)).astype(np.float32)
    qkv[:, n_valid:] = 0.0
    t = torch.from_numpy(qkv).view(b, n, 3, heads, 64)
    q, k, v = (t[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    return qkv, q, k, v


@pytest.mark.parametrize("b,n,heads,n_valid,bias_dtype", [
    (2, 256, 2, 256, None), (2, 256, 2, 200, None), (1, 384, 4, 301, None),
    (2, 256, 2, 200, "float32"), (2, 256, 2, 200, "bfloat16"), (2, 256, 2, 256, "float32"),
    (2, 896, 6, 785, None),  # the KNN / train shape at full width (N padded to 896 for JAX)
])
def test_attention_emulation_matches_jax(pallas_interpret, b, n, heads, n_valid, bias_dtype):
    import jax.numpy as jnp

    jatt, _ = pallas_interpret
    qkv, q, k, v = _qkv_case(b, n, heads, n_valid, seed=n + heads)
    scale = 64 ** -0.5
    bias = jbias = None
    if bias_dtype is not None:
        rng = np.random.default_rng(7)
        raw = (2.0 * rng.standard_normal((heads, n, n))).astype(np.float32)
        bias = torch.from_numpy(raw).to(getattr(torch, bias_dtype))
        jbias = jnp.asarray(raw, getattr(jnp, bias_dtype))
    ref = np.asarray(jatt.whole_kv_mha_qkv(jnp.asarray(qkv), heads, scale, n_valid,
                                           bias=jbias))
    out = emulate_attention(q, k, v, scale, n_valid, bias)
    assert torch.all(out[:, :, n_valid:] == 0)
    got = out.permute(0, 2, 1, 3).reshape(b, n, heads * 64)
    assert_attention_close(got[:, :n_valid], torch.from_numpy(ref[:, :n_valid]), "vs JAX")
    assert_attention_close(out, attention_f64(q, k, v, scale, n_valid, bias), "vs float64")


@pytest.mark.parametrize("fold_tiles,within", [(True, True), (False, False)])
def test_attention_tile_fold_keeps_the_limit_at_n1601(fold_tiles, within):
    """The eval shape's N=1601 (26 key tiles): with each tile's P V folded
    into O on the CUDA cores the emulation is within the float32 limits of
    float64; with O carried in the truncating accumulator it is not (the
    card measured 1.19e-5 relative there)."""
    _, q, k, v = _qkv_case(1, 1601, 6, 1601, seed=11)
    out = emulate_attention(q, k, v, 64 ** -0.5, fold_tiles=fold_tiles)
    ref = attention_f64(q, k, v, 64 ** -0.5, 1601)
    rel = ((out.double() - ref).norm() / ref.norm()).item()
    assert (rel <= ATT_TOL[1] / 2) if within else (rel > ATT_TOL[1])


def test_attention_emulation_ignores_keys_past_n_valid():
    _, q, k, v = _qkv_case(1, 200, 2, 150, seed=3)
    out = emulate_attention(q, k, v, 0.125, 150)
    k, v = k.clone(), v.clone()
    k[:, :, 150:] = float("inf")
    v[:, :, 150:] = float("inf")
    assert torch.equal(emulate_attention(q, k, v, 0.125, 150), out)


# ---------------------------------------------------------------- K4


def _scene_feats(size=32, seeds=(0, 1)):
    """[len(seeds), size^2, 5] features of fidelity scenes (x/67, y/67,
    rgb/3: colors up to ~85) at full resolution."""
    feats = []
    for seed in seeds:
        image = make_scene(size, 27, seed=seed)[0]
        ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        f = np.concatenate([xs[None] / 67.0, ys[None] / 67.0, image / 3.0])
        feats.append(f.reshape(5, -1).T)
    return np.stack(feats).astype(np.float32)


@pytest.mark.parametrize("kind,n", [("normal", 300), ("normal", 777), ("scene", 1024),
                                    ("scene", 1000)])
@pytest.mark.parametrize("c", [1, 27, 54, 70])
def test_bilateral_emulation_matches_jax_and_float64(pallas_interpret, kind, n, c):
    """N=300 and 777 end in a ragged key tile, 1000 cuts a scene's last rows;
    C=70 is the kernel's second channel chunk."""
    import jax.numpy as jnp

    _, jpallas = pallas_interpret
    rng = np.random.default_rng(c + n)
    if kind == "normal":
        feats = rng.standard_normal((2, n, 5)).astype(np.float32)
    else:
        feats = np.ascontiguousarray(_scene_feats()[:, :n])
    values = rng.random((2, n, c)).astype(np.float32)
    out = emulate_bilateral(torch.from_numpy(feats), torch.from_numpy(values))
    assert_k4_close(out, bilateral_f64(torch.from_numpy(feats), torch.from_numpy(values)),
                    what="vs float64")
    pallas = np.stack([np.asarray(jpallas.bilateral_message_pallas(
        jnp.asarray(fb), jnp.asarray(vb))) for fb, vb in zip(feats, values)])
    limit = K4_LIMIT if kind == "normal" else SCENE_PALLAS_LIMIT
    assert_k4_close(out, torch.from_numpy(pallas), limit, what="vs JAX Pallas")
