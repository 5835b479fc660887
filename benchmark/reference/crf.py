"""Plain PyTorch dense-CRF mean field at the mixed-resolution operating point
with phase grids (the eval CLI's default: ds 8, 4 quincunx phases, splat
sigma 1.8, a 5-iteration coarse prefix, a 4-iteration half-resolution mid
prefix, a bfloat16 state and an int8 kernel cache).

A frozen copy of the port's `ops/crf.py` algorithm at that point, written
without its batching, streaming and kernel paths: the splat/slice operator
A = S^T K S as pooling products, the kernel exp(-|f_i - f_j|^2 / 2) cached
per image, quantized to int8 at the fixed scale 127, and its products
with the per-image quantized state summed exactly (float64). Imports
nothing but torch and numpy; TF32 must be off in the caller.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize(x, size, dtype_out=None):
    """Bilinear, align_corners=False, in float32 (or in x's dtype when
    ``dtype_out`` is the input's own)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    y = F.interpolate(x.float() if dtype_out is None else x, size=size, mode="bilinear",
                      align_corners=False)
    return y.to(x.dtype) if dtype_out is None else y


def _gauss_band(n, sigma, dev, dt):
    idx = np.arange(n, dtype=np.float64)
    m = np.exp(-((idx[:, None] - idx[None, :]) ** 2) / (2.0 * sigma * sigma)).astype(np.float32)
    return torch.from_numpy(m).to(dev, dt)


def gaussian_filter(q, sigma):
    gh = _gauss_band(q.shape[-2], sigma, q.device, q.dtype)
    gw = _gauss_band(q.shape[-1], sigma, q.device, q.dtype)
    return gh @ q @ gw.T


def pool_matrix(n, ds, dev, dt):
    m = torch.zeros(n // ds, n)
    for i in range(n // ds):
        m[i, i * ds:(i + 1) * ds] = 1.0
    return m.to(dev, dt)


def kernel_int8(f: torch.Tensor) -> torch.Tensor:
    """[N, 5] scaled features -> [N, N] int8 round(127 exp(-|fi - fj|^2 / 2))
    via the augmented product, in float32."""
    a = f.float()
    k = torch.exp(a @ a.T - 0.5 * (a * a).sum(1)[:, None] - 0.5 * (a * a).sum(1)[None, :])
    return torch.round(k * 127.0).to(torch.int8)


def int8_message(kmats, z, dt):
    """K z per image with z quantized at zmax / 127 per image; the int8
    sums exact in float64, rescaled and returned in ``dt``."""
    zmax = z.abs().amax(dim=(1, 2), keepdim=True).float().clamp_min(1e-20)
    z8 = torch.round(z.float() * (127.0 / zmax)).to(torch.int8)
    out = torch.stack([(k.double() @ zi.double()).float() for k, zi in zip(kmats, z8)])
    return (out * (zmax / (127.0 * 127.0))).to(dt)


def phase_offsets(p, ds):
    a, b, c = ds // 4, (3 * ds) // 4, ds // 2
    return {1: [(c, c)], 2: [(a, a), (b, b)], 4: [(a, a), (a, b), (b, a), (b, b)]}[p]


def jbu_operator(image, c, ds, dt, phases, kmats=None, want_coarse=False):
    """(apply, coarse, kmats) of the joint-bilateral splat/slice operator
    over the phase grids; ``c`` holds the CRF settings."""
    b, _, h, w = image.shape
    hd, wd = h // ds, w // ds
    nc, p = hd * wd, len(phases)
    dev = image.device
    rgb = image.float() / c["bi_rgb_std"]
    feats, wgts = [], []
    for oy, ox in phases:
        img_p = image[:, :, oy::ds, ox::ds].float() / c["bi_rgb_std"]
        ys = (torch.arange(hd, device=dev, dtype=torch.float32) * ds + oy) / c["bi_xy_std"]
        xs = (torch.arange(wd, device=dev, dtype=torch.float32) * ds + ox) / c["bi_xy_std"]
        pos = torch.stack([xs[None, :].expand(hd, wd), ys[:, None].expand(hd, wd)])
        f = torch.cat([pos[None].expand(b, 2, hd, wd), img_p], dim=1)
        feats.append(f.reshape(b, 5, nc).transpose(1, 2))
        up = img_p.repeat_interleave(ds, -2).repeat_interleave(ds, -1)
        wgts.append(torch.exp(-0.5 * ((rgb - up) ** 2).sum(1) / c["splat_sigma_factor"] ** 2))
    bf = torch.cat(feats, dim=1)
    n = p * nc
    if kmats is None:
        kmats = [kernel_int8(bf[i]) for i in range(b)]
    wgt = torch.stack(wgts, dim=1)

    def message(z):
        return int8_message(kmats, z, dt)

    def make_apply(wc):
        def apply(q):
            ch = q.shape[1]
            wq = wc.to(q.dtype)
            ph, pw = pool_matrix(h, ds, dev, q.dtype), pool_matrix(w, ds, dev, q.dtype)
            z = torch.stack([ph @ (q * wq[:, i, None]) @ pw.T for i in range(p)], dim=1)
            z = z.reshape(b, p, ch, nc).transpose(2, 3).reshape(b, n, ch)
            m = message(z.to(dt)).reshape(b, p, nc, ch).transpose(2, 3) \
                .reshape(b, p, ch, hd, wd).to(q.dtype)
            out = None
            for i in range(p):
                u = (ph.T @ m[:, i] @ pw) * wq[:, i, None]
                out = u if out is None else out + u
            return out
        return apply

    deg = make_apply(wgt)(torch.ones((b, 1, h, w), device=dev))[:, 0]
    wgt_norm = wgt * deg.clamp_min(1e-20).rsqrt()[:, None]
    coarse = None
    if want_coarse:
        deg_c = message(torch.ones((b, n, 1), device=dev, dtype=dt))
        isd_c = deg_c[..., 0].float().clamp_min(1e-20).rsqrt()

        def coarse_message(qc):
            z = (qc.float() * isd_c[:, None]).transpose(1, 2).to(dt)
            return message(z).transpose(1, 2).float() * isd_c[:, None]

        def slice_full(mc):
            ch = mc.shape[1]
            m = mc.reshape(b, ch, p, hd, wd)
            out = None
            for i in range(p):
                u = m[:, :, i].repeat_interleave(ds, -2).repeat_interleave(ds, -1) * wgt[:, i, None]
                out = u if out is None else out + u
            return out

        coarse = (coarse_message, slice_full)
    return make_apply(wgt_norm), coarse, kmats


def dense_crf(images, logits_list, c: dict):
    """images [B, 3, H, W] 0..255, logit sets [B, C_k, h, w] -> refined Q
    per set, [B, C_k, H, W] float32."""
    if not (c["mixed_resolution"] and c["splat_phases"] == 4 and c["kernel_int8"]
            and c["coarse_prefix"] > 0 and c["mid_prefix"] > 0 and c["downsample"] % 4 == 0):
        raise ValueError("the reference covers the phase-grid point with both prefixes only")
    cs = [lg.shape[1] for lg in logits_list]
    b, h, w = images.shape[0], *images.shape[-2:]
    ds = c["downsample"]
    dt = torch.bfloat16 if c["dtype"] == "bfloat16" else torch.float32
    probs = torch.cat([torch.softmax(resize(lg, (h, w)).float(), dim=1) for lg in logits_list],
                      dim=1)
    phases = phase_offsets(c["splat_phases"], ds)
    cp = min(c["coarse_prefix"], c["max_iter"])
    mp = min(c["mid_prefix"], c["max_iter"] - cp)
    apply_full, _, kmats = jbu_operator(images, c, ds, dt, phases)
    c_mid = dict(c, bi_xy_std=c["bi_xy_std"] / 2)
    apply_mid, coarse_mid, _ = jbu_operator(images[:, :, ::2, ::2], c_mid, ds // 2, dt,
                                            [(oy // 2, ox // 2) for oy, ox in phases],
                                            kmats=kmats, want_coarse=True)

    def softmax_sets(x):
        return torch.cat([torch.softmax(part.float(), dim=1)
                          for part in torch.split(x, cs, dim=1)], dim=1).to(dt)

    def run_grid(q, lu, sigma, apply_bilateral, n_iter):
        ones = torch.ones((1, 1, *lu.shape[-2:]), device=lu.device)
        isd = gaussian_filter(ones, sigma).clamp_min(1e-20).rsqrt().to(dt)
        for _ in range(n_iter):
            mg = gaussian_filter(q * isd, sigma) * isd
            mb = apply_bilateral(q)
            q = softmax_sets(lu + c["pos_w"] * mg.float() + c["bi_w"] * mb.float())
        return q

    log_unary = probs.clamp_min(1e-20).log()
    cmsg, slice_q = coarse_mid
    cch = log_unary.shape[1]
    lu_c = torch.cat([log_unary[:, :, oy::ds, ox::ds].reshape(b, cch, -1) for oy, ox in phases],
                     dim=2)
    qc = softmax_sets(lu_c)
    for _ in range(cp):
        qc = softmax_sets(lu_c + c["bi_w"] * cmsg(qc))
    sliced = torch.split(slice_q(qc.float()), cs, dim=1)
    q = torch.cat([s / s.sum(1, keepdim=True).clamp_min(1e-20) for s in sliced], dim=1).to(dt)
    q = run_grid(q, log_unary[:, :, ::2, ::2], c["pos_xy_std"] / 2, apply_mid, mp)
    q = resize(q, (h, w), dtype_out=q.dtype)
    q = run_grid(q, log_unary, c["pos_xy_std"], apply_full, c["max_iter"] - cp - mp)
    return list(torch.split(q.float(), cs, dim=1))

