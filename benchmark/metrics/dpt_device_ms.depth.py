"""dpt_device_ms.depth (ms/step): the stream time of the `dpt` spans
(`ZoeDepth.forward`: `dpt.decode`, the DPT decoder; one a pass, two a
step) under each `depth.step` span of the traced stretch, over the depth
steps (`benchmark.spans`)."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "depth.step", "dpt", "device_ms"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
