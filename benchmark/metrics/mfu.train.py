"""mfu.train (%): the train step's model operations, counted from the
configuration's widths (`counting.train_step_flops`: the frozen ViT on the
image and on its positive, the head's forward and backward on both, the
probes), over the untraced window's step time, against the H100's dense
bf16 peak."""

from benchmark.counting import PEAK_BF16_FLOPS


def read(spec, out):
    c = out["counts"]
    if not c["steps"]:
        return None
    return 100.0 * c["step_flops"] * c["steps"] / (c["window_s"] * PEAK_BF16_FLOPS)
