"""Synchronising host<->device copies a run: the program's spans named
``sync.*`` in the window (one a copy), over the window's runs. None where
the program has no span of its host seams (``sync.*`` or ``scan.*``)."""


def read(rec):
    if rec.window_ns is None:
        return None
    t0, t1 = rec.window_ns
    names = [n for n, a, b in rec.spans if t0 <= a and b <= t1]
    if not any(n.startswith(("sync.", "scan.")) for n in names):
        return None
    return sum(n.startswith("sync.") for n in names) / len(rec.runs)
