"""k1_launches_per_step.depth (launches/step): K1 launches inside each
`depth.step` span of the traced stretch (`ops.attention.KERNEL.launches`
read at the span's edges), over the depth steps (`benchmark.spans`)."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "depth.step", "depth.step", "k1_launches"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
