"""Device milliseconds a run of the scan kernel (``fused_search``: the
grouped partial kernel, then the split merge or the device lists' decode),
from the profiler's trace of the window, averaged over its runs."""

KERNELS = ("fused_grouped_partial", "fused_search_merge", "fused_search_decode")


def read(rec):
    s = rec.kernel_s(KERNELS)
    return None if s is None else s * 1e3 / len(rec.runs)
