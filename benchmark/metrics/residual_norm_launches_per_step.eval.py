"""residual_norm_launches_per_step.eval (launches/step): the ViT's residual
junction kernel's launches inside each `eval.step` span of the traced
stretch (`ops.residual_norm.KERNEL.launches` read at the span's edges:
three a block and one for the final norm, one stacked backbone call a
step: 37 a ViT-S/8 or ViT-B/8 step, 121 a ViT-g step), over the eval steps
(`benchmark.spans`). Nothing from a program whose spans do not carry that
counter, and nothing when an eval step launched the kernel no time: a step
that ran its junctions without the kernel has lost it, which is no gain."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "eval.step", "eval.step", "residual_norm_launches"


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
