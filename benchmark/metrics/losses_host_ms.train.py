"""losses_host_ms.train (ms/step): the self host time of the
`train.forward` span (`train.step.loss_fn` less its `backbone` spans: the
head, FPS, sampling, the losses and the probes) under each `train.step`
span of the traced stretch, over the train steps (`benchmark.spans`). Read
under the traced stretch's profiler, which records every host operation:
the step's host time about doubles there, unevenly across the phases."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "train.step", "train.forward", "self_host_ms"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
