"""residual_norm_launches_per_step.depth_dav2 (launches/step): the ViT's
residual junction kernel's launches inside each `depth.step` span of the
traced stretch (`ops.residual_norm.KERNEL.launches` read at the span's
edges: three a block of Depth Anything V2's ViT-L and one a normed tap, 76
a step), over the depth steps (`benchmark.spans`). Nothing from a program
whose spans do not carry that counter, and nothing when a depth step
launched the kernel no time (ZoeDepth's BEiT, or a step that ran its
junctions without the kernel: a lost kernel is no gain)."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "depth.step", "depth.step", "residual_norm_launches"


def read(spec, out):
    try:
        mean = per_step(STEP, SPAN, KEY)
    except KeyError:  # spans recorded without the counter
        return None
    if mean is None:
        return None
    from depthg_tpu_torch.utils import profiling

    steps = [s[KEY] for s in profiling.collect()["spans"]
             if s["parent"] is None and s["name"] == STEP]
    return mean if min(steps) > 0 else None
