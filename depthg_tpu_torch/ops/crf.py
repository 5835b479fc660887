"""Dense-CRF mean-field refinement at the eval default operating point
(``depthg_tpu/ops/crf.py``).

Ported: the point ``crf_config_from_cfg({})`` resolves to — ``ds=8 jbu4
sf1.8 cp5 m4 bf16 pm-int8`` — and the schedules of the same family (other
coarse/mid prefixes, f32 state). That is:

* the joint-bilateral splat/slice operator A = S^T K S over P pure-color
  phase grids (``_jbu_operator``), with its splat/slice as full-resolution
  multiplies plus ds-block pooling matmuls and the rsqrt degree folded into
  the splat weights;
* the materialized bilateral kernel exp(-|f_i - f_j|^2 / 2) over the
  [P * nc, 5] phase-point features, built in full float32 (TF32 off:
  ``runtime.configure_numerics``) and cached as int8 with fixed scale 127;
* each message as an int8 x int8 -> int32 product against a dynamically
  scaled int8 copy of the distributions (``torch._int_mm`` on CUDA, exact
  float64 on the CPU);
* the exact separable Gaussian as two dense banded matmuls;
* the mixed schedule: ``coarse_prefix`` iterations on the phase points,
  ``mid_prefix`` at half resolution, the rest at full resolution.

Every other configuration raises ``NotImplementedError`` naming its ROADMAP
item: the streaming ``_bilateral_message`` (a point set whose cache would
exceed 2700 MiB), the legacy non-mixed schedule, the phase-free mixed path
(``safe``), the broadcast splat, and a non-int8 cache. (``quality_plus``,
ds=4 with 2 phases, resolves to a supported configuration.)

Batching: batched tensor ops over the image axis, except the int8 product
(``torch._int_mm`` has no batch form) and the float32 kernel build (one
[N, N] transient at a time), which loop over images. The TPU's batch
strategies, vmap budgets and unroll limits are not ported.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from depthg_tpu_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class CRFConfig:
    """The fields of the JAX ``CRFConfig`` that ``crf_config_from_cfg`` sets
    or the mean field reads (see the comments there). Not carried over: the
    streaming tile size ``block``, ``use_pallas``, ``kernel_cache_mb`` and
    ``batch_strategy``, which select TPU paths the port does not have."""
    max_iter: int = 10
    pos_w: float = 3.0
    pos_xy_std: float = 1.0
    bi_w: float = 4.0
    bi_xy_std: float = 67.0
    bi_rgb_std: float = 3.0
    downsample: int = 2
    mixed_resolution: bool = True
    dtype: str = "float32"
    splat_phases: int = 0
    splat_sigma_factor: float = 1.0
    kernel_int8: bool = False
    coarse_prefix: int = 0
    mid_prefix: int = 0
    splat_impl: str = "broadcast"


# largest per-image kernel cache; a larger point set would need the
# streaming bilateral message (the JAX default kernel_cache_mb)
_KERNEL_CACHE_BYTES = 2700 * 2**20


EVAL_OPERATING_POINTS = {
    "default": {},
    "quality_plus": {"crf_downsample": 4},
    "fast": {"crf_coarse_prefix": 8},
    "safe": {"crf_downsample": 4, "crf_splat_phases": 0},
}


def operating_point_overrides(name: str) -> list:
    """A named operating point as ``k=v`` config-override strings, applied
    before the user's own overrides."""
    return [f"{k}={v}" for k, v in EVAL_OPERATING_POINTS[name].items()]


def crf_config_from_cfg(cfg) -> CRFConfig:
    """CRF operating point from run-config keys (same defaults as the JAX
    package: ds=8, 4 phases, sigma 1.8, bf16 state, cp5 m4, pool-matmul
    splat/slice, int8 cache)."""
    ds = int(cfg.get("crf_downsample", 8))
    phases = int(cfg.get("crf_splat_phases", {8: 4, 4: 2}.get(ds, 0)))
    cp = int(cfg.get("crf_coarse_prefix", 5 if (ds == 8 and phases == 4) else 0))
    return CRFConfig(
        downsample=ds,
        splat_phases=phases,
        splat_sigma_factor=float(cfg.get("crf_splat_sigma",
                                         {8: 1.8, 4: 1.41}.get(ds, 1.0))),
        dtype=str(cfg.get("crf_dtype", "bfloat16")),
        mixed_resolution=bool(cfg.get("crf_mixed_resolution", True)),
        splat_impl=str(cfg.get("crf_splat_impl",
                               "pool_matmul" if phases else "broadcast")),
        kernel_int8=bool(cfg.get("crf_kernel_int8", bool(phases))),
        coarse_prefix=cp,
        mid_prefix=int(cfg.get("crf_mid_prefix",
                               4 if (ds == 8 and phases == 4 and cp in (3, 5))
                               else 0)),
    )


def _phase_offsets(p: int, ds: int) -> list:
    """Representative-pixel offsets of the P phase grids in a ds x ds cell:
    diagonal for P=2, quincunx for P=4."""
    if p <= 0 or ds <= 1:
        return []
    a, b, c = ds // 4, (3 * ds) // 4, ds // 2
    if p == 1:
        return [(c, c)]
    if p == 2:
        return [(a, a), (b, b)]
    if p == 4:
        return [(a, a), (a, b), (b, a), (b, b)]
    raise ValueError(f"splat_phases must be 0, 1, 2 or 4; got {p}")


def _jbu_phases(ccfg: CRFConfig, h: int, w: int) -> list:
    """Phase grids of the joint-bilateral path at (h, w), or [] when inactive."""
    ds = ccfg.downsample
    if not (ccfg.mixed_resolution and ds > 1 and h % ds == 0 and w % ds == 0):
        return []
    return _phase_offsets(ccfg.splat_phases, ds)


def _check_supported(ccfg: CRFConfig, h: int, w: int) -> list:
    phases = _jbu_phases(ccfg, h, w)
    why = None
    if not ccfg.mixed_resolution:
        why = "the legacy non-mixed schedule"
    elif not phases:
        why = "the phase-free mixed path (operating point 'safe', ds<=2)"
    elif ccfg.splat_impl != "pool_matmul":
        why = f"splat_impl={ccfg.splat_impl!r}"
    elif not ccfg.kernel_int8:
        why = "a bf16/f32 kernel cache"
    elif (len(phases) * (h // ccfg.downsample) * (w // ccfg.downsample)) ** 2 \
            > _KERNEL_CACHE_BYTES:
        why = "the streaming bilateral message (kernel cache too large)"
    if why is not None:
        raise NotImplementedError(
            f"dense CRF: {why} is not ported yet (ROADMAP: other CRF points "
            "and the streaming bilateral message); the port runs the eval "
            "default family ds=8 jbu4 pool_matmul int8-cache")
    return phases


@functools.lru_cache(maxsize=64)
def _pool_matrix(n: int, ds: int, device: torch.device, dtype: torch.dtype):
    """[n // ds, n] 0/1 block-sum indicator (ds-cell pooling as a matmul)."""
    m = torch.zeros(n // ds, n)
    for i in range(n // ds):
        m[i, i * ds:(i + 1) * ds] = 1.0
    return m.to(device, dtype)


@functools.lru_cache(maxsize=64)
def _gauss_band(n: int, sigma: float, device: torch.device, dtype: torch.dtype):
    """Dense [n, n] 1-D Gaussian kernel matrix exp(-(i-j)^2 / 2 sigma^2)."""
    idx = np.arange(n, dtype=np.float64)
    d = idx[:, None] - idx[None, :]
    m = np.exp(-(d * d) / (2.0 * sigma * sigma)).astype(np.float32)
    return torch.from_numpy(m).to(device, dtype)


def _gaussian_filter(q: torch.Tensor, sigma: float) -> torch.Tensor:
    """Exact separable Gaussian over the last two axes of q [..., H, W]."""
    h, w = q.shape[-2:]
    gh = _gauss_band(h, sigma, q.device, q.dtype)
    gw = _gauss_band(w, sigma, q.device, q.dtype)
    return gh @ q @ gw.T


def bilateral_kernel(feats: torch.Tensor) -> torch.Tensor:
    """[N, 5] features (scaled by their sigmas) -> [N, N] float32 kernel
    exp(a.b - |a|^2/2 - |b|^2/2). The cross term is O(1e3) while the
    log-kernel needs ~0.1 absolute accuracy: this must run in full float32
    (TF32 off), as the JAX package pins HIGHEST precision."""
    f = feats.float()
    sq = (f * f).sum(1)
    return torch.exp(f @ f.T - 0.5 * sq[:, None] - 0.5 * sq[None, :])


def cache_kernel_int8(feats: torch.Tensor) -> torch.Tensor:
    """[B, N, 5] -> [B, N, N] int8 kernel cache, fixed scale 127 (entries live
    in (0, 1], the diagonal is exactly 127); built one image at a time."""
    b, n, _ = feats.shape
    out = torch.empty((b, n, n), dtype=torch.int8, device=feats.device)
    for i in range(b):
        out[i] = torch.round(bilateral_kernel(feats[i]) * 127.0).to(torch.int8)
    return out


def _int8_matmul(kmat: torch.Tensor, z8: torch.Tensor) -> torch.Tensor:
    """[B, N, N] int8 @ [B, N, C] int8 -> [B, N, C] (int32 sums as float32).

    CUDA: ``torch._int_mm`` per image, with C zero-padded to a multiple of 8
    (its constraint) and the right operand column-major. CPU: float64, which
    is exact here (|sum| <= N * 127^2 < 2^53)."""
    if kmat.device.type == "cpu":
        return torch.bmm(kmat.double(), z8.double()).float()
    b, n, c = z8.shape
    cp = -(-c // 8) * 8
    zp = torch.zeros((b, cp, n), dtype=torch.int8, device=z8.device)
    zp[:, :c] = z8.transpose(1, 2)
    out = torch.stack([torch._int_mm(kmat[i], zp[i].T) for i in range(b)])
    return out[..., :c].float()


def cached_matmul(kmat: torch.Tensor, z: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """kmat @ z for an int8 cache: z is quantized per image with a dynamic
    scale zmax/127 (round half to even), the product accumulates in int32,
    and the result is rescaled and returned in ``dt``."""
    zmax = z.abs().amax(dim=(1, 2), keepdim=True).float().clamp_min(1e-20)
    z8 = torch.round(z.float() * (127.0 / zmax)).to(torch.int8)
    return (_int8_matmul(kmat, z8) * (zmax / (127.0 * 127.0))).to(dt)


def _jbu_operator(image: torch.Tensor, ccfg: CRFConfig, ds: int, dt, phases,
                  kmat=None, want_coarse: bool = False):
    """Joint-bilateral splat/slice operator A = S^T K S over a batch.

    image: [B, 3, H, W] raw 0..255. Returns (apply_A, coarse, kmat):
    apply_A: [B, C, H, W] -> the normalized message D^-1/2 A D^-1/2 q (the
    rsqrt degree folded into the splat weights); ``coarse`` = (message on
    the phase-point set, color-weighted slice to [B, C, H, W]) when
    ``want_coarse``; ``kmat``: the int8 [B, P*nc, P*nc] cache, built here
    unless one with identical point features is passed in."""
    b, _, h, w = image.shape
    hd, wd = h // ds, w // ds
    nc = hd * wd
    p = len(phases)
    dev = image.device
    rgb_full = image.float() / ccfg.bi_rgb_std

    feats_list, wgt_list = [], []
    for oy, ox in phases:
        img_p = image[:, :, oy::ds, ox::ds].float() / ccfg.bi_rgb_std  # [B,3,hd,wd]
        ys = (torch.arange(hd, device=dev, dtype=torch.float32) * ds + oy) / ccfg.bi_xy_std
        xs = (torch.arange(wd, device=dev, dtype=torch.float32) * ds + ox) / ccfg.bi_xy_std
        pos = torch.stack([xs[None, :].expand(hd, wd), ys[:, None].expand(hd, wd)])
        f = torch.cat([pos[None].expand(b, 2, hd, wd), img_p], dim=1)
        feats_list.append(f.reshape(b, 5, nc).transpose(1, 2))
        cell_up = img_p.repeat_interleave(ds, -2).repeat_interleave(ds, -1)
        wgt_list.append(torch.exp(-0.5 * ((rgb_full - cell_up) ** 2).sum(1)
                                  / ccfg.splat_sigma_factor ** 2))
    bf = torch.cat(feats_list, dim=1)  # [B, P*nc, 5], phase-major
    n_pts = p * nc
    if kmat is None:
        kmat = cache_kernel_int8(bf)
    wgt_c = torch.stack(wgt_list, dim=1)  # [B, P, H, W]

    def make_apply(wc):
        def apply_pool_matmul(q):
            c = q.shape[1]
            wq = wc.to(q.dtype)
            ph = _pool_matrix(h, ds, dev, q.dtype)  # [hd, H]
            pw = _pool_matrix(w, ds, dev, q.dtype)  # [wd, W]
            z = torch.stack([ph @ (q * wq[:, pi, None]) @ pw.T
                             for pi in range(p)], dim=1)  # [B, P, C, hd, wd]
            z = z.reshape(b, p, c, nc).transpose(2, 3).reshape(b, n_pts, c)
            mc = cached_matmul(kmat, z.to(dt), dt)
            m = (mc.reshape(b, p, nc, c).transpose(2, 3)
                 .reshape(b, p, c, hd, wd).to(q.dtype))
            out = None
            for pi in range(p):
                u = (ph.T @ m[:, pi] @ pw) * wq[:, pi, None]
                out = u if out is None else out + u
            return out
        return apply_pool_matmul

    deg = make_apply(wgt_c)(torch.ones((b, 1, h, w), device=dev))[:, 0]
    wgt_norm = wgt_c * deg.clamp_min(1e-20).rsqrt()[:, None]

    coarse = None
    if want_coarse:
        ones_c = torch.ones((b, n_pts, 1), device=dev, dtype=dt)
        isd_c = cached_matmul(kmat, ones_c, dt)[..., 0].float().clamp_min(1e-20).rsqrt()

        def coarse_message(qc):
            """[B, C, n_pts] -> D^-1/2 K D^-1/2 qc (coarse degree), float32."""
            z = (qc.float() * isd_c[:, None]).transpose(1, 2).to(dt)
            return cached_matmul(kmat, z, dt).transpose(1, 2).float() * isd_c[:, None]

        def slice_full(mc):
            """Color-weighted slice [B, C, n_pts] -> [B, C, H, W]."""
            c = mc.shape[1]
            m = mc.reshape(b, c, p, hd, wd)
            out = None
            for pi in range(p):
                u = (m[:, :, pi].repeat_interleave(ds, -2).repeat_interleave(ds, -1)
                     * wgt_c[:, pi, None])
                out = u if out is None else out + u
            return out

        coarse = (coarse_message, slice_full)
    return make_apply(wgt_norm), coarse, kmat


def dense_crf_multi_batch(images: torch.Tensor, logits_list,
                          ccfg: CRFConfig = CRFConfig()):
    """Mean-field refinement of several logit sets sharing each image's kernel.

    images: [B, 3, H, W] raw 0..255; logits_list: list of [B, C_k, h, w] at
    any resolution (bilinearly upsampled to H, W). Returns a list of refined
    Q [B, C_k, H, W] float32."""
    cs = [lg.shape[1] for lg in logits_list]
    h, w = images.shape[-2:]
    phases = _check_supported(ccfg, h, w)
    ds = ccfg.downsample
    dt = torch.bfloat16 if ccfg.dtype == "bfloat16" else torch.float32
    probs = torch.cat([torch.softmax(resize_bilinear(lg, (h, w)).float(), dim=1)
                       for lg in logits_list], dim=1)  # [B, sum(C), H, W]

    cp = min(max(int(ccfg.coarse_prefix), 0), ccfg.max_iter)
    mid_ok = ds % 2 == 0 and all(oy % 2 == 0 and ox % 2 == 0 for oy, ox in phases)
    mp = min(max(int(ccfg.mid_prefix), 0), ccfg.max_iter - cp) if mid_ok else 0
    jbu_apply, jbu_coarse, kmat = _jbu_operator(
        images, ccfg, ds, dt, phases, want_coarse=(cp > 0 and mp == 0))
    if mp:
        # half-res operator over the strided image: every phase offset is
        # even, so its points are the same pixels and the cache is shared;
        # halving bi_xy_std keeps the position features identical
        ccfg_mid = dataclasses.replace(ccfg, bi_xy_std=ccfg.bi_xy_std / 2)
        jbu_apply_mid, jbu_coarse_mid, _ = _jbu_operator(
            images[:, :, ::2, ::2], ccfg_mid, ds // 2, dt,
            [(oy // 2, ox // 2) for oy, ox in phases], kmat=kmat,
            want_coarse=cp > 0)
        if cp:
            jbu_coarse = jbu_coarse_mid  # the coarse prefix hands off at mid res

    def blockwise_softmax(x):
        """Softmax per logit set along channels, in float32, stored in dt."""
        return torch.cat([torch.softmax(part.float(), dim=1)
                          for part in torch.split(x, cs, dim=1)], dim=1).to(dt)

    log_unary = probs.clamp_min(1e-20).log()

    def run_grid(q, lu, sigma, apply_bilateral, n_iter):
        """n_iter mean-field iterations at lu's resolution: exact separable
        Gaussian (symmetrically normalized) + the bilateral operator."""
        ones = torch.ones((1, 1, *lu.shape[-2:]), device=lu.device)
        isd = _gaussian_filter(ones, sigma).clamp_min(1e-20).rsqrt().to(dt)
        for _ in range(n_iter):
            mg = _gaussian_filter(q * isd, sigma) * isd
            mb = apply_bilateral(q)
            q = blockwise_softmax(lu + ccfg.pos_w * mg.float()
                                  + ccfg.bi_w * mb.float())
        return q

    if cp:
        cmsg, slice_q = jbu_coarse
        b, cch = log_unary.shape[:2]
        lu_c = torch.cat([log_unary[:, :, oy::ds, ox::ds].reshape(b, cch, -1)
                          for oy, ox in phases], dim=2)  # [B, C, n_pts]
        qc = blockwise_softmax(lu_c)
        for _ in range(cp):
            qc = blockwise_softmax(lu_c + ccfg.bi_w * cmsg(qc))
        sliced = torch.split(slice_q(qc.float()), cs, dim=1)
        q = torch.cat([s / s.sum(1, keepdim=True).clamp_min(1e-20)
                       for s in sliced], dim=1).to(dt)
    else:
        q = (probs[:, :, ::2, ::2] if mp else probs).to(dt)
    if mp:
        q = run_grid(q, log_unary[:, :, ::2, ::2], ccfg.pos_xy_std / 2,
                     jbu_apply_mid, mp)
        q = resize_bilinear(q, (h, w), fast=True)
    q = run_grid(q, log_unary, ccfg.pos_xy_std, jbu_apply, ccfg.max_iter - cp - mp)
    return list(torch.split(q.float(), cs, dim=1))
