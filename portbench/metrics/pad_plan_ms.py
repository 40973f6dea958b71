"""Host milliseconds a run building the scan's padding plan: the summed
duration of the program's spans ``scan.pad_plan`` in the window (one a
memo miss), over the window's runs; 0.0 where the program spans the scan's
prologue (``scan.sort_pad``) and the memo never missed, None where it has
no such span."""


def read(rec):
    if rec.window_ns is None:
        return None
    t0, t1 = rec.window_ns
    spans = [(n, b - a) for n, a, b in rec.spans if t0 <= a and b <= t1]
    if not any(n == "scan.sort_pad" for n, _ in spans):
        return None
    return sum(d for n, d in spans if n == "scan.pad_plan") / 1e6 / len(rec.runs)
