"""host_syncs_per_step.train (syncs/step): the calls inside each `train.step`
span of the traced stretch that make the host wait for the device
(`utils.profiling.host_sync`, whose `host_syncs` counter is read at the
span's edges), over the train steps (`benchmark.spans`). A step without
such a call reads 0. Nothing from a program whose spans do not carry the
counter."""

from benchmark.spans import per_step

STEP, SPAN, KEY = "train.step", "train.step", "host_syncs"


def read(spec, out):
    try:
        return per_step(STEP, SPAN, KEY)
    except KeyError:  # spans recorded without the counter
        return None
