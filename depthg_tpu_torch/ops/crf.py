"""Dense-CRF mean-field refinement (``depthg_tpu/ops/crf.py``) at every
operating point the JAX ``CRFConfig`` reaches.

* Mixed resolution with phases (the eval default ``ds=8 jbu4 sf1.8 cp5 m4
  bf16 pm-int8``, ``quality_plus``, ``fast``): the joint-bilateral
  splat/slice operator A = S^T K S over P pure-color phase grids
  (``_jbu_operator``), as pooling matmuls (``pool_matmul``) or a
  cell-blocked contraction (``broadcast``), with the rsqrt degree folded
  into the splat weights; the coarse prefix on the phase points and the
  half-resolution mid prefix.
* Mixed resolution without phases (``safe``, ``ds=2/4 mixed``): the
  bilateral message on a bilinearly downsampled image, resized in and out.
* The legacy schedule (``mixed_resolution=False``): the whole mean field
  at the working resolution, then upsampled and renormalized. At
  ``downsample=1`` this is the exact CRF.

The exact separable Gaussian is two dense banded matmuls. The bilateral
kernel exp(-|f_i - f_j|^2 / 2) is cached per image when it fits
``kernel_cache_mb`` (int8 with fixed scale 127 and an int8 x int8 -> int32
product, or the state dtype and a plain ``bmm``), built in full float32
(TF32 off: ``runtime.configure_numerics``). A point set whose cache would
not fit streams through ``ops/crf_bilateral.bilateral_message`` (the K4
kernel on CUDA), which never stores the kernel.

Batching: batched tensor ops over the image axis, except the int8 product
(``torch._int_mm`` has no batch form) and the cache build (one image at a
time). The caches of a batch are held together up to ``CACHE_BUDGET_BYTES``;
a larger batch runs in groups of images that fit it (at ``downsample=2`` a
float32 cache is 2.44 GiB per image), as the JAX package's cache-sized
chunks do. Whether a point set caches depends on its size alone, never on
free memory. The TPU's batch strategies, vmap budgets and unroll limits
are not ported.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from depthg_tpu_torch.ops.crf_bilateral import bilateral_degree, bilateral_message, \
    row_blocks
from depthg_tpu_torch.ops.resize import resize_bilinear
from depthg_tpu_torch.utils.profiling import counted, int8_matmul_flops


@dataclasses.dataclass(frozen=True)
class CRFConfig:
    """The fields of the JAX ``CRFConfig`` that ``crf_config_from_cfg`` sets
    or the mean field reads (see the comments there). Not carried over: the
    streaming tile size ``block``, ``use_pallas`` and ``batch_strategy``,
    which select TPU paths the port does not have."""
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
    # largest per-image kernel cache (MiB); larger point sets stream, 0
    # never caches
    kernel_cache_mb: int = 2700
    kernel_int8: bool = False
    coarse_prefix: int = 0
    mid_prefix: int = 0
    splat_impl: str = "broadcast"


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
    """Phase grids of the joint-bilateral path at (h, w), or [] when inactive
    (non-mixed, ds <= 1, no phases, or a resolution ds does not divide)."""
    ds = ccfg.downsample
    if not (ccfg.mixed_resolution and ds > 1 and h % ds == 0 and w % ds == 0):
        return []
    return _phase_offsets(ccfg.splat_phases, ds)


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


def bilateral_kernel(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """[M, 5], [N, 5] features (scaled by their sigmas) -> [M, N] float32
    kernel exp(a.b - |a|^2/2 - |b|^2/2). The cross term is O(1e3) while the
    log-kernel needs ~0.1 absolute accuracy: this must run in full float32
    (TF32 off), as the JAX package pins HIGHEST precision."""
    a, b = fa.float(), fb.float()
    return torch.exp(a @ b.T - 0.5 * (a * a).sum(1)[:, None]
                     - 0.5 * (b * b).sum(1)[None, :])


def cache_kernel_int8(feats: torch.Tensor) -> torch.Tensor:
    """[B, N, 5] -> [B, N, N] int8 kernel cache, fixed scale 127 (entries live
    in (0, 1], the diagonal is exactly 127); built one image at a time."""
    b, n, _ = feats.shape
    out = torch.empty((b, n, n), dtype=torch.int8, device=feats.device)
    for i in range(b):
        out[i] = torch.round(bilateral_kernel(feats[i], feats[i]) * 127.0).to(torch.int8)
    return out


# largest total of kernel caches held at once by one call (32 GiB of the
# H100's 80 GB): a batch beyond it runs in groups of images
CACHE_BUDGET_BYTES = 32 * 2 ** 30


def _kernel_cache_bytes(n_pts: int, ccfg: CRFConfig) -> int | None:
    """Per-image bytes of a cached kernel, or None when it must stream."""
    itemsize = 1 if ccfg.kernel_int8 else 2 if ccfg.dtype == "bfloat16" else 4
    nbytes = n_pts * n_pts * itemsize
    if 0 < ccfg.kernel_cache_mb and nbytes <= ccfg.kernel_cache_mb * 2 ** 20:
        return nbytes
    return None


def _cache_kernel(feats: torch.Tensor, ccfg: CRFConfig, dt) -> torch.Tensor:
    """[B, N, 5] -> [B, N, N] cache in its storage dtype: int8, or the state
    dtype ``dt`` (built in float32 row blocks, one image at a time).

    Every cache is built by ``bilateral_kernel``, the JAX cache's augmented
    form, not the direct distance of the streaming message: in eager torch
    it is one GEMM and two broadcast subtractions per block, about a third
    of the memory passes of five broadcast differences. Its ~1e-3 relative
    cancellation noise per entry lies below the rounding of a bf16 entry
    (2^-8 relative) or an int8 one (1/127 absolute); a float32 cache keeps
    it, as the JAX package's float32 cache does."""
    if ccfg.kernel_int8:
        return cache_kernel_int8(feats)
    b, n, _ = feats.shape
    out = torch.empty((b, n, n), dtype=dt, device=feats.device)
    for i in range(b):
        for r0, r1 in row_blocks(1, n):
            out[i, r0:r1] = bilateral_kernel(feats[i, r0:r1], feats[i]).to(dt)
    return out


@counted(lambda kmat, z8: z8.shape[0] * int8_matmul_flops(kmat.shape[1], *z8.shape[1:]))
def _int8_matmul(kmat: torch.Tensor, z8: torch.Tensor) -> torch.Tensor:
    """[B, N, N] int8 @ [B, N, C] int8 -> [B, N, C] (int32 sums as float32),
    counted for ``step_flops`` as B [N, N] x [N, C] products (C unpadded).

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
    """kmat @ z in the cache's storage dtype. A bf16/f32 cache is a plain
    ``bmm`` against z in the same dtype. For an int8 cache, z is quantized
    per image with a dynamic scale zmax/127 (round half to even), the product
    accumulates in int32, and the result is rescaled and returned in ``dt``."""
    if kmat.dtype != torch.int8:
        return torch.bmm(kmat, z)
    zmax = z.abs().amax(dim=(1, 2), keepdim=True).float().clamp_min(1e-20)
    z8 = torch.round(z.float() * (127.0 / zmax)).to(torch.int8)
    return (_int8_matmul(kmat, z8) * (zmax / (127.0 * 127.0))).to(dt)


def _message(bf: torch.Tensor, kmat, z: torch.Tensor, dt) -> torch.Tensor:
    """K @ z [B, N, C]: through the cache when there is one, else streaming."""
    return cached_matmul(kmat, z, dt) if kmat is not None else bilateral_message(bf, z)


def _jbu_operator(image: torch.Tensor, ccfg: CRFConfig, ds: int, dt, phases,
                  kmat=None, want_coarse: bool = False):
    """Joint-bilateral splat/slice operator A = S^T K S over a batch.

    image: [B, 3, H, W] raw 0..255. Returns (apply_A, coarse, kmat):
    apply_A: [B, C, H, W] -> the normalized message D^-1/2 A D^-1/2 q (the
    rsqrt degree folded into the splat weights); ``coarse`` = (message on
    the phase-point set, color-weighted slice to [B, C, H, W]) when
    ``want_coarse``; ``kmat``: the [B, P*nc, P*nc] cache, built here unless
    one with identical point features is passed in, or None when the point
    set streams (``kernel_cache_mb``)."""
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
    bf = torch.cat(feats_list, dim=1).contiguous()  # [B, P*nc, 5], phase-major
    n_pts = p * nc
    if kmat is None and _kernel_cache_bytes(n_pts, ccfg) is not None:
        kmat = _cache_kernel(bf, ccfg, dt)
    wgt_c = torch.stack(wgt_list, dim=1)  # [B, P, H, W]

    def message(z):
        """[B, n_pts, C] -> [B, n_pts, C] in dt (z in dt)."""
        return _message(bf, kmat, z.contiguous(), dt)

    def make_apply(wc):
        def apply_pool_matmul(q):
            c = q.shape[1]
            wq = wc.to(q.dtype)
            ph = _pool_matrix(h, ds, dev, q.dtype)  # [hd, H]
            pw = _pool_matrix(w, ds, dev, q.dtype)  # [wd, W]
            z = torch.stack([ph @ (q * wq[:, pi, None]) @ pw.T
                             for pi in range(p)], dim=1)  # [B, P, C, hd, wd]
            z = z.reshape(b, p, c, nc).transpose(2, 3).reshape(b, n_pts, c)
            mc = message(z.to(dt))
            m = (mc.reshape(b, p, nc, c).transpose(2, 3)
                 .reshape(b, p, c, hd, wd).to(q.dtype))
            out = None
            for pi in range(p):
                u = (ph.T @ m[:, pi] @ pw) * wq[:, pi, None]
                out = u if out is None else out + u
            return out

        def apply_broadcast(q):
            # the same operator as one contraction over each ds x ds cell
            c = q.shape[1]
            wq = wc.to(q.dtype).reshape(b, p, hd, ds, wd, ds)
            z = torch.einsum("bciajd,bpiajd->bpcij",
                             q.reshape(b, c, hd, ds, wd, ds), wq)
            z = z.reshape(b, p, c, nc).transpose(2, 3).reshape(b, n_pts, c)
            mc = message(z.to(dt))
            m = (mc.reshape(b, p, nc, c).transpose(2, 3)
                 .reshape(b, p, c, hd, wd).to(q.dtype))
            return torch.einsum("bpcij,bpiajd->bciajd", m, wq).reshape(b, c, h, w)

        return apply_pool_matmul if ccfg.splat_impl == "pool_matmul" else apply_broadcast

    deg = make_apply(wgt_c)(torch.ones((b, 1, h, w), device=dev))[:, 0]
    wgt_norm = wgt_c * deg.clamp_min(1e-20).rsqrt()[:, None]

    coarse = None
    if want_coarse:
        if kmat is not None:
            ones_c = torch.ones((b, n_pts, 1), device=dev, dtype=dt)
            deg_c = cached_matmul(kmat, ones_c, dt)
        else:
            deg_c = bilateral_degree(bf)
        isd_c = deg_c[..., 0].float().clamp_min(1e-20).rsqrt()

        def coarse_message(qc):
            """[B, C, n_pts] -> D^-1/2 K D^-1/2 qc (coarse degree), float32."""
            z = (qc.float() * isd_c[:, None]).transpose(1, 2).to(dt)
            return message(z).transpose(1, 2).float() * isd_c[:, None]

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


def _bilateral_features(image: torch.Tensor, ccfg: CRFConfig, ds: int) -> torch.Tensor:
    """[B, N, 5] features (x, y, r, g, b) scaled by their stds of a working-
    resolution image [B, 3, h, w] (0..255); positions are cell centers."""
    b, _, h, w = image.shape
    dev = image.device
    ys = (torch.arange(h, device=dev, dtype=torch.float32) * ds + (ds - 1) / 2.0) \
        / ccfg.bi_xy_std
    xs = (torch.arange(w, device=dev, dtype=torch.float32) * ds + (ds - 1) / 2.0) \
        / ccfg.bi_xy_std
    pos = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)])
    f = torch.cat([pos[None].expand(b, 2, h, w), image.float() / ccfg.bi_rgb_std], 1)
    return f.reshape(b, 5, h * w).transpose(1, 2).contiguous()


def _grid_bilateral(image_d: torch.Tensor, ccfg: CRFConfig, ds: int, dt):
    """Bilateral message on the working grid of the phase-free mixed path and
    the legacy schedule: [B, C, hd, wd] in dt -> D^-1/2 K D^-1/2 q in dt,
    K over the pixels of ``image_d`` [B, 3, hd, wd]."""
    b, _, hd, wd = image_d.shape
    n = hd * wd
    bf = _bilateral_features(image_d, ccfg, ds)
    kmat = (_cache_kernel(bf, ccfg, dt)
            if _kernel_cache_bytes(n, ccfg) is not None else None)
    if kmat is not None:
        deg = cached_matmul(kmat, torch.ones((b, n, 1), device=bf.device, dtype=dt), dt)
    else:
        deg = bilateral_degree(bf)
    isd = deg[..., 0].float().clamp_min(1e-20).rsqrt().to(dt)[:, None]  # [B, 1, N]

    def bilateral(q):
        c = q.shape[1]
        z = (q.reshape(b, c, n) * isd).transpose(1, 2).contiguous()  # [B, N, C]
        mb = _message(bf, kmat, z, dt).transpose(1, 2)
        return (mb * isd).reshape(b, c, hd, wd)

    return bilateral


def dense_crf_multi_batch(images: torch.Tensor, logits_list,
                          ccfg: CRFConfig = CRFConfig()):
    """Mean-field refinement of several logit sets sharing each image's kernel.

    images: [B, 3, H, W] raw 0..255; logits_list: list of [B, C_k, h, w] at
    any resolution (bilinearly upsampled to H, W). Returns a list of refined
    Q [B, C_k, H, W] float32."""
    cs = [lg.shape[1] for lg in logits_list]
    b, h, w = images.shape[0], *images.shape[-2:]
    ds = ccfg.downsample
    mixed = ccfg.mixed_resolution and ds > 1
    hd, wd = (h // ds, w // ds) if ds > 1 else (h, w)
    phases = _jbu_phases(ccfg, h, w)
    per_img = _kernel_cache_bytes(hd * wd * max(1, len(phases)), ccfg)
    group = max(1, CACHE_BUDGET_BYTES // per_img) if per_img else b
    if group < b:
        outs = [dense_crf_multi_batch(images[i:i + group],
                                      [lg[i:i + group] for lg in logits_list], ccfg)
                for i in range(0, b, group)]
        return [torch.cat(parts) for parts in zip(*outs)]
    dt = torch.bfloat16 if ccfg.dtype == "bfloat16" else torch.float32
    probs = torch.cat([torch.softmax(resize_bilinear(lg, (h, w)).float(), dim=1)
                       for lg in logits_list], dim=1)  # [B, sum(C), H, W]

    cp = mp = 0
    if phases:
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
    else:
        image_d = (resize_bilinear(images.float(), (hd, wd)) if ds > 1
                   else images.float())
        bilateral = _grid_bilateral(image_d, ccfg, ds, dt)

    def blockwise_softmax(x):
        """Softmax per logit set along channels, in float32, stored in dt."""
        return torch.cat([torch.softmax(part.float(), dim=1)
                          for part in torch.split(x, cs, dim=1)], dim=1).to(dt)

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

    if not mixed:
        # legacy: the whole mean field at the working resolution
        probs_d = resize_bilinear(probs, (hd, wd)) if ds > 1 else probs
        q = run_grid(probs_d.to(dt), probs_d.clamp_min(1e-20).log(),
                     ccfg.pos_xy_std / ds, bilateral, ccfg.max_iter).float()
        if ds == 1:
            return list(torch.split(q, cs, dim=1))
        q = resize_bilinear(q, (h, w))
        return [p / p.sum(1, keepdim=True).clamp_min(1e-20)
                for p in torch.split(q, cs, dim=1)]

    log_unary = probs.clamp_min(1e-20).log()
    if phases:
        bilateral_full = jbu_apply  # normalization in the splat weights
    else:
        def bilateral_full(q):
            # native-dtype resizes: q lives in [0, 1] and each iteration
            # re-softmaxes from the float32 unary
            q_coarse = resize_bilinear(q, (hd, wd), fast=True)
            return resize_bilinear(bilateral(q_coarse), (h, w), fast=True)

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
    q = run_grid(q, log_unary, ccfg.pos_xy_std, bilateral_full,
                 ccfg.max_iter - cp - mp)
    return list(torch.split(q.float(), cs, dim=1))


def dense_crf_batch(images: torch.Tensor, logits: torch.Tensor,
                    ccfg: CRFConfig = CRFConfig()) -> torch.Tensor:
    """Batched refinement: images [B, 3, H, W], logits [B, C, h, w] ->
    Q [B, C, H, W]."""
    return dense_crf_multi_batch(images, [logits], ccfg)[0]


def dense_crf(image: torch.Tensor, logits: torch.Tensor,
              ccfg: CRFConfig = CRFConfig()) -> torch.Tensor:
    """One image: image [3, H, W] raw 0..255, logits [C, h, w] -> Q [C, H, W]."""
    return dense_crf_batch(image[None], logits[None], ccfg)[0]
