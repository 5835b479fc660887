"""logits_device_ms.eval (ms/step): the stream time of the `logits` spans
(`inference.eval_logits` in `predictions`: the flip-TTA batch and
average, the projection head, both probes resized to `label_res`) under
each `eval.step` span of the traced stretch, less the stream time of the
`backbone` spans inside them, over the eval steps (`benchmark.spans`).
Nothing when a step's `logits` spans hold no `backbone` span."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "eval.step", "logits", "device_ms"
INNER = "backbone"


def read(spec, out):
    total = per_step(STEP, SPAN, KEY)
    if total is None:
        return None
    from depthg_tpu_torch.utils import profiling

    spans = profiling.collect()["spans"]
    roots = {s["id"] for s in spans if s["parent"] is None and s["name"] == STEP}
    outer = {s["id"] for s in spans if s["name"] == SPAN and s["step"] in roots}
    inner = [s for s in spans if s["name"] == INNER and s["parent"] in outer]
    if {s["step"] for s in inner} != roots or any(s[KEY] is None for s in inner):
        return None
    return total - sum(s[KEY] for s in inner) / len(roots)
