"""crf_cache_launches_per_step.eval (launches/step): launches of the CRF's
int8 cache kernel inside each `eval.step` span of the traced
stretch (`ops.crf_bilateral.KERNEL.cache_launches` read at the span's
edges), over the eval steps (`benchmark.spans`). Nothing from a program
whose spans do not carry that counter, and nothing when an eval step
launched the kernel no time: a step that built its cache without the
kernel has lost it, which is no gain."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "eval.step", "eval.step", "crf_cache_launches"


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
