"""Host milliseconds a run in the program's span ``pipeline.scan``, the
spans nested in it included: from the scan's entry to its kernel in flight
and the output's gathers enqueued, summed over the window, over its runs."""


def read(rec):
    if rec.window_ns is None:
        return None
    t0, t1 = rec.window_ns
    d = [b - a for n, a, b in rec.spans if n == "pipeline.scan" and t0 <= a and b <= t1]
    return sum(d) / 1e6 / len(rec.runs) if d else None
