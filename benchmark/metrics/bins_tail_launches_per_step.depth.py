"""bins_tail_launches_per_step.depth (launches/step): launches of the
metric-bins head's full-resolution tail kernel inside each `depth.step`
span of the traced stretch (`ops.zoe_bins.KERNEL.bins_launches` read at the
span's edges), over the depth steps (`benchmark.spans`): one a pass for the
whole batch. Nothing from a program whose spans do not carry that counter,
and nothing when a depth step launched the kernel no time: a step that ran
the tail without the kernel has lost it, which is no gain."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "depth.step", "depth.step", "bins_tail_launches"


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
