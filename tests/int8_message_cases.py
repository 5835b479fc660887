"""Inputs and the library yardstick for holding the CRF's int8 message
kernel (``depthg_tpu_torch.ops.crf_bilateral.int8_message``) on the card. It
holds no tests: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` import
this one copy. Imports torch only.

``int_mm_message`` is the route the port took before the kernel: the same
eager quantize and rescale, the product by ``torch._int_mm`` image by image
behind a zero-padded transposed copy of the operand (C padded to a multiple
of 8; N must be one too). The port never calls it. Its int32 sums are exact,
as the kernel's are, so the two agree bit for bit; at an N off a multiple of
8 the plain version (``int8_message_plain``: the same eager ops, the product
in float64, exact) is the reference.
"""

import torch


def inputs(device, b, n, c, dtype, seed=0):
    """(cache [B, N, N] int8 in [0, 127], z [B, N, C] in ``dtype``): uniform
    cache bytes, and z spread over [0, 1) as the CRF's normalized
    probabilities are (C = 1: ones, the degree's operand)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kmat = torch.randint(0, 128, (b, n, n), generator=gen, device=device, dtype=torch.int8)
    if c == 1:
        return kmat, torch.ones((b, n, 1), device=device, dtype=dtype)
    z = torch.rand((b, n, c), generator=gen, device=device) * torch.rand(
        (b, 1, 1), generator=gen, device=device)
    return kmat, z.to(dtype)


def int_mm_message(kmat, z, dt):
    """The int8 message by ``torch._int_mm`` per image (the library call)."""
    zmax = z.abs().amax(dim=(1, 2), keepdim=True).float().clamp_min(1e-20)
    z8 = torch.round(z.float() * (127.0 / zmax)).to(torch.int8)
    b, n, c = z8.shape
    cp = -(-c // 8) * 8
    zp = torch.zeros((b, cp, n), dtype=torch.int8, device=z8.device)
    zp[:, :c] = z8.transpose(1, 2)
    out = torch.stack([torch._int_mm(kmat[i], zp[i].T) for i in range(b)])
    return (out[..., :c].float() * (zmax / (127.0 * 127.0))).to(dt)
