"""The share of the window in which no operation ran on the device:
1 - (union of the device's activity in the profiler's trace) / window."""


def read(rec):
    if not rec.busy_s or rec.window_ns is None:
        return None
    return 1.0 - rec.busy_s / ((rec.window_ns[1] - rec.window_ns[0]) / 1e9)
