"""out_head_device_ms.depth_dav2 (ms/step): the stream time of the
`out_head` spans (`DepthAnythingV2.forward`: `output_conv1`, the resize to
the input size, `output_conv2` and its ReLUs; one a step) under each
`depth.step` span of the traced stretch, over the depth steps
(`benchmark.spans`). Nothing from a program without that span."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "depth.step", "out_head", "device_ms"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
