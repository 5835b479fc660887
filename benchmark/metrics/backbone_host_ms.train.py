"""backbone_host_ms.train (ms/step): the host time of the `backbone` spans
(`models.featurizer.backbone_features`: the weights' bf16 copy and the
frozen ViT, two a step) under each `train.step` span of the traced
stretch, over the train steps (`benchmark.spans`). Read
under the traced stretch's profiler, which records every host operation:
the step's host time about doubles there, unevenly across the phases."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "train.step", "backbone", "host_ms"


def read(spec, out):
    return per_step(STEP, SPAN, KEY)
