"""backbone_device_ms.eval (ms/step): the stream time of the `backbone`
spans (`models.featurizer.backbone_features`: the weights' bf16 copy and
the frozen ViT) under each `eval.step` span of the traced stretch, over the
eval steps (`benchmark.spans`)."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "eval.step", "backbone", "device_ms"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
