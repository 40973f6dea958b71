"""The share of the window's runs whose padding plan missed the program's
memo: spans ``scan.pad_plan`` (one a miss) in the window over its runs.
None where the program has no span of the scan's prologue
(``scan.sort_pad``)."""


def read(rec):
    if rec.window_ns is None:
        return None
    t0, t1 = rec.window_ns
    names = [n for n, a, b in rec.spans if t0 <= a and b <= t1]
    if "scan.sort_pad" not in names:
        return None
    return names.count("scan.pad_plan") / len(rec.runs)
