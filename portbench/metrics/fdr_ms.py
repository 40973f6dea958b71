"""Host milliseconds a run in the program's span ``pipeline.fdr``, less
any span nested in it, averaged over the window's runs."""


def read(rec):
    s = rec.span_self_s("pipeline.fdr")
    return None if s is None else s * 1e3 / len(rec.runs)
