"""backward_host_ms.train (ms/step): the host time of the `backward` span
(`loss.backward()` over the head and probes) under each `train.step` span
of the traced stretch, over the train steps (`benchmark.spans`). Read
under the traced stretch's profiler, which records every host operation:
the step's host time about doubles there, unevenly across the phases."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "train.step", "backward", "host_ms"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
