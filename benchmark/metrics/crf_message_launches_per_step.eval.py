"""crf_message_launches_per_step.eval (launches/step): the CRF's int8
messages launched inside each `eval.step` span of the traced stretch
(`ops.crf_bilateral.KERNEL.message_launches` read at the span's edges: one
a message, each a quantize and a product launch for the batch), over the
eval steps (`benchmark.spans`). Nothing from a program whose spans do not
carry that counter, and nothing when an eval step launched the message
kernel no time: a step that ran its messages without the kernel has lost
it, which is no gain."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "eval.step", "eval.step", "crf_message_launches"


def read(spec, out):
    try:
        mean = per_step(STEP, SPAN, KEY)
    except KeyError:  # spans recorded without the counter
        return None
    if mean is None:
        return None
    from depthg_tpu_torch.utils import profiling

    steps = [s[KEY] for s in profiling.collect()["spans"]
             if s["parent"] is None and s["name"] == STEP]
    return mean if min(steps) > 0 else None
