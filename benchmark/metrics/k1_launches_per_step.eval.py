"""k1_launches_per_step.eval (launches/step): K1 launches inside each
`eval.step` span of the traced stretch (`ops.attention.KERNEL.launches`
read at the span's edges), over the eval steps (`benchmark.spans`)."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "eval.step", "eval.step", "k1_launches"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
