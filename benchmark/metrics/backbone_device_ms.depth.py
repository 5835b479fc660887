"""backbone_device_ms.depth (ms/step): the stream time of the `backbone`
spans (`ZoeDepth.forward`: BEiT-L, its relative-position bias lookup
included; one a pass, two a step) under each `depth.step` span of the
traced stretch, over the depth steps (`benchmark.spans`)."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "depth.step", "backbone", "device_ms"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
