"""The scan kernel's share of its roofline, in percent: the least time the
card could take for the pairs and bytes the window's runs need
(``portbench/roofline.py``), over the kernel's device time."""

KERNELS = ("fused_grouped_partial", "fused_search_merge", "fused_search_decode")


def read(rec):
    s = rec.kernel_s(KERNELS)
    if s is None or not rec.work:
        return None
    return 100.0 * sum(rec.work[j]["bound_s"] for _, _, j, _ in rec.runs) / s
