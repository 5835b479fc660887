"""swiglu_device_ms.eval_dinov2 (ms/step): the stream time of the `swiglu`
spans (`models.vit.SwiGLU`: w12, the SiLU gate and w3; one a block) under
each `eval.step` span of the traced stretch, over the eval steps
(`benchmark.spans`). Nothing from a program whose steps hold no such span."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "eval.step", "swiglu", "device_ms"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
