"""mfu.depth (%): the depth step's model operations, counted from the
configuration's widths and the bucket's image size (`counting_depth.step_flops`:
both passes of BEiT-L's linears and attention, DPT's convolutions and
readouts, the metric-bins head's convolutions), over the untraced window's
step time, against the H100's dense bf16 peak."""

from benchmark.counting import PEAK_BF16_FLOPS


def read(spec, out):
    c = out["counts"]
    if not c["steps"]:
        return None
    return 100.0 * c["step_flops"] * c["steps"] / (c["window_s"] * PEAK_BF16_FLOPS)
