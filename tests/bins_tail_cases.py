"""Inputs and yardsticks for holding ZoeDepth's bins tail kernel
(``depthg_tpu_torch.ops.zoe_bins.bins_tail``) to its plain version on the
card. It holds no tests: ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
import this one copy. Imports torch only.

The metric depth is judged per image by the 99th percentile of |kernel -
plain| over the plain image's depth range and by the largest |kernel -
plain| over that range, the worst image of each. The kernel rounds where
the bf16 module rounds, so nearly every pixel is equal to float32 rounding:
the 99th percentile read 1.9e-7 (these inputs, B=2 at 384 x 512 and 416 x
544) and 3.3e-7 (the depth cell's own inputs, B=8) on an H100, against
P99_TOL = 1e-5. A few pixels are not: where a product's sum lands its bf16
rounding one step apart (another order of accumulation), that pixel's
probability or temperature moves a bf16 step and, at a low temperature, its
mode moves a bin: the largest gap read 1.2% of the range (1.0% on the
cell's inputs); MAX_TOL = 0.1 stays above the widest gap between
neighbouring centers a pixel is likely to hold (~6.5% of the range for 64
sorted uniform centers). feats (the resized embedding) is held to one bf16
step of the plain version's, a step floored at 2^-20 of the embedding's
largest magnitude: float32's rounding of the interpolation's terms, which a
value that cancels to near zero keeps (these inputs put such a value 107
steps from the plain one, 4e-8 apart); at most FEATS_SHARE of the elements
may differ at all (2.5e-6 and 4e-7 read).
"""

import torch

P99_TOL = 1e-5
MAX_TOL = 0.1
FEATS_SHARE = 1e-4


def head(device, seed=0, n_bins=64, emb=128, bottleneck=80):
    """A bf16 ConditionalLogBinomial at the depth cell's head magnitudes:
    1x1 convolutions at 1/sqrt(inputs), the output one at 10 times that,
    the temperature channels' biases at -/+3."""
    from depthg_tpu_torch.models.zoedepth import heads

    gen = torch.Generator().manual_seed(seed)
    clb = heads.ConditionalLogBinomial(33, emb, n_bins, bottleneck, 0.0212, 50.0)
    with torch.no_grad():
        clb.mlp[0].weight.normal_(0.0, (33 + emb) ** -0.5, generator=gen)
        clb.mlp[0].bias.normal_(0.0, (33 + emb) ** -0.5, generator=gen)
        clb.mlp[2].weight.normal_(0.0, 10 * bottleneck ** -0.5, generator=gen)
        clb.mlp[2].bias.copy_(torch.tensor([0.0, 0.0, -3.0, 3.0]))
    return clb.to(device, torch.bfloat16)


def inputs(device, b, h, w, seed=0, emb=128, n_bins=64):
    """(out_conv, rel, prev_emb, b_centers) in bf16 as the decoder leaves
    them: channels-last maps, the embedding and the sorted positive centers
    at half the size."""
    gen = torch.Generator().manual_seed(seed)
    cl = torch.channels_last
    out_conv = torch.relu(torch.randn(b, 32, h, w, generator=gen))
    rel = torch.rand(b, 1, h, w, generator=gen) * 3.0
    prev_emb = torch.randn(b, emb, h // 2, w // 2, generator=gen)
    centers = torch.sort(torch.rand(b, n_bins, h // 2, w // 2, generator=gen) * 10.0 + 0.05,
                         dim=1).values
    return (out_conv.to(device, torch.bfloat16).contiguous(memory_format=cl),
            rel.to(device, torch.bfloat16),
            prev_emb.to(device, torch.bfloat16).contiguous(memory_format=cl),
            centers.to(device, torch.bfloat16).contiguous(memory_format=cl))


def depth_gaps(got, ref):
    """(99th percentile, max) of |got - ref| over ref's range, worst image;
    NaN where an output is not finite."""
    g, r = got.flatten(1).float(), ref.flatten(1).float()
    span = (r.amax(1) - r.amin(1)).clamp_min(1e-12)
    diff = (g - r).abs()
    return ((torch.quantile(diff, 0.99, dim=1) / span).max().item(),
            (diff.amax(1) / span).max().item())


def feats_apart(got, ref, prev_emb):
    """(elements more than one bf16 step apart, share of elements that
    differ at all); a NaN counts as apart."""
    g, r = got.float(), ref.float()
    big = torch.maximum(g.abs(), r.abs()).clamp_min(1e-38)
    step = torch.maximum(torch.exp2(torch.floor(torch.log2(big)) - 7),
                         prev_emb.float().abs().max() * 2.0 ** -20)
    return int((~((g - r).abs() <= step)).sum()), float((g != r).float().mean())


def holds(depth, feats, ref_depth, ref_feats, prev_emb) -> dict:
    """The kernel's outputs against the plain version's, with the limits."""
    p99, worst = depth_gaps(depth, ref_depth)
    apart, share = feats_apart(feats, ref_feats, prev_emb)
    return {"depth_p99_over_range": p99, "depth_max_over_range": worst,
            "feats_apart": apart, "feats_share_differing": share,
            "passes": p99 <= P99_TOL and worst <= MAX_TOL and apart == 0
            and share <= FEATS_SHARE}
