"""confusion_device_ms.eval (ms/step): the stream time of the two
`confusion` spans (`inference.predictions`' two argmaxes, then
`inference.make_eval_step`'s two confusion blocks and their sum) under each
`eval.step` span of the traced stretch, over the eval steps
(`benchmark.spans`). It holds the device's idle time while the host reads
each block's bincount bounds back (`host_sync`)."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "eval.step", "confusion", "device_ms"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
