"""launches_per_step.train (launches/step): device kernels in the traced
stretch over the train steps in it (the host's launch rate sets the pace
of this step)."""


def read(spec, out):
    tr = out["trace"]
    if not tr["steps"] or not tr["n_kernels"]:
        return None
    return tr["n_kernels"] / tr["steps"]
