"""k1_roofline_pct.eval (%): the least time of the traced steps' attention
(`counting.eval_attention_bound_s` per step: operations at the bf16 peak or
bytes at 3.35 TB/s per call, whichever is larger) over the device time of
the attention kernels in the trace. The kernels read are the port's bf16
K1 entry (`csrc/attention.cu`), by name."""

KERNEL_NAMES = ("attn_bf16_wgmma_kernel",)


def read(spec, out):
    tr = out["trace"]
    dev_s = sum(d for name, d in tr["kernels"] if any(k in name for k in KERNEL_NAMES))
    if dev_s <= 0:
        return None
    return 100.0 * out["counts"]["attention_bound_s"] * tr["steps"] / dev_s
