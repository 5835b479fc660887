"""bins_device_ms.depth (ms/step): the stream time of the `bins` spans
(`ZoeDepth.forward`: `conv2` through the log-binomial and the depth sum,
with their resizes; one a pass, two a step) under each `depth.step` span
of the traced stretch, over the depth steps (`benchmark.spans`)."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "depth.step", "bins", "device_ms"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
