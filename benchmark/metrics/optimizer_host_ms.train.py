"""optimizer_host_ms.train (ms/step): the host time of the two `optimizer`
spans (the three `zero_grad`s; the gradients' average and the three Adam
steps) under each `train.step` span of the traced stretch, over the train
steps (`benchmark.spans`). Read
under the traced stretch's profiler, which records every host operation:
the step's host time about doubles there, unevenly across the phases."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "train.step", "optimizer", "host_ms"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
