"""Query spectra answered per second: every spectrum of the runs finished
in the window over all the time from the first submit to the last answer
on the host."""


def read(rec):
    if not rec.runs:
        return None
    span_ns = rec.runs[-1][1] - rec.runs[0][0]
    return sum(r[3] for r in rec.runs) / (span_ns / 1e9)
