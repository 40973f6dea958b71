"""Host milliseconds a run in synchronising host<->device copies: the
summed duration of the program's spans named ``sync.*`` in the window, over
the window's runs. None where the program has no span of its host seams
(``sync.*`` or ``scan.*``)."""


def read(rec):
    if rec.window_ns is None:
        return None
    t0, t1 = rec.window_ns
    spans = [(n, b - a) for n, a, b in rec.spans if t0 <= a and b <= t1]
    if not any(n.startswith(("sync.", "scan.")) for n, _ in spans):
        return None
    return sum(d for n, d in spans if n.startswith("sync.")) / 1e6 / len(rec.runs)
