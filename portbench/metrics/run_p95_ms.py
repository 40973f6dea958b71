"""The 95th percentile, over every MS run in the window, of the time from
its submit to its answer on the host (numpy's linear interpolation)."""
import numpy as np


def read(rec):
    if not rec.runs:
        return None
    return float(np.percentile([(b - a) / 1e6 for a, b, _, _ in rec.runs], 95))
