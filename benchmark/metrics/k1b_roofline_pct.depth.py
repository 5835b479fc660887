"""k1b_roofline_pct.depth (%): the least time of the traced steps' attention
(`counting_depth.step_attention_bound_s` per step: per call, operations at
the bf16 peak or q, k, v, o and the [heads, N, N] bias at 3.35 TB/s,
whichever is larger) over the device time of the attention kernels that
carried a bias in the trace: the port's bf16 K1 entry (`csrc/attention.cu`)
instantiated with a bias (its first template argument, `BIAS`, 1 or 2),
by name."""

import re

KERNEL = re.compile(r"attn_bf16_wgmma_kernel<\s*[12]\s*,")


def read(spec, out):
    tr = out["trace"]
    dev_s = sum(d for name, d in tr["kernels"] if KERNEL.search(name))
    if dev_s <= 0:
        return None
    return 100.0 * out["counts"]["attention_bound_s"] * tr["steps"] / dev_s
