"""k1_launches_per_step.train (launches/step): K1 launches inside each
`train.step` span of the traced stretch (`ops.attention.KERNEL.launches`
read at the span's edges), over the train steps (`benchmark.spans`)."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "train.step", "train.step", "k1_launches"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
