"""swiglu_gate_launches_per_step.eval_dinov2 (launches/step): the SwiGLU
gate kernel's launches inside each `eval.step` span of the traced stretch
(`ops.swiglu.KERNEL.gate_launches` read at the span's edges: one a
DINOv2 block, 40 a ViT-g step), over the eval steps (`benchmark.spans`).
Nothing from a program whose spans do not carry that counter, and nothing
when an eval step launched the gate kernel no time: a step that ran its
gates without the kernel has lost it, which is no gain."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "eval.step", "eval.step", "swiglu_gate_launches"


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
