"""device_idle_pct (%): the share of the traced stretch's host time in which
no operation ran on the device (the union of the profiler's device
intervals)."""


def read(spec, out):
    tr = out["trace"]
    if tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - tr["busy_s"] / tr["window_s"])
