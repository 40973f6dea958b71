"""The comparison that decides ``correct``: every kept answer of the window
against the plain reference's answer to the same MS run, entry by entry.

An answer is what a lab receives for one run: per window (standard and
open) the winners' library indices and similarities at every rank, and the
FDR's accept flags and q-values. The configuration states an exact top-k,
ranked by similarity desc with ties broken by position in the library
sorted by (charge, precursor m/z, decoy after target, library index),
and the target-decoy FDR, so each number compared is a count of entries
that differ, and its limit is 0.
"""
from __future__ import annotations

import numpy as np

FIELDS = ("open_idx", "open_sim", "std_idx", "std_sim",
          "open_accept", "open_q", "std_accept", "std_q")
LIMITS = {"winners_off": 0, "fdr_off": 0}


def answer_of(out) -> dict:
    """The host copy of one ``OMSOutput``: the answer a lab receives."""
    r, o, s = out.result, out.open_fdr, out.std_fdr
    ts = (r.open_idx, r.open_sim, r.std_idx, r.std_sim,
          o.accept, o.q_values, s.accept, s.q_values)
    return {f: t.cpu().numpy() for f, t in zip(FIELDS, ts)}


def differences(answer: dict, ref: dict) -> dict:
    """Entries of ``answer`` that differ from ``ref``: ``winners_off``
    counts (query, rank, window) whose index or similarity differ,
    ``fdr_off`` those whose accept flag or q-value differ (a q-value of
    another shape counts whole)."""
    out = {"winners_off": 0, "fdr_off": 0}
    for w in ("open", "std"):
        for names, key in (((f"{w}_idx", f"{w}_sim"), "winners_off"),
                           ((f"{w}_accept", f"{w}_q"), "fdr_off")):
            a0, r0 = np.asarray(answer[names[0]]), np.asarray(ref[names[0]])
            a1, r1 = np.asarray(answer[names[1]]), np.asarray(ref[names[1]])
            if a0.shape != r0.shape or a1.shape != r1.shape:
                out[key] += int(max(r0.size, a0.size))
                continue
            out[key] += int(((a0 != r0) | (a1 != r1)).sum())
    return out


def compare(kept: dict, refs: dict) -> dict:
    """``kept``: pool index -> list of answers; ``refs``: pool index -> the
    reference's answer. Returns the summed differences, the answers with
    any difference (``failed``) and the counts of answers and entries
    compared."""
    total = {k: 0 for k in LIMITS}
    answers = entries = failed = 0
    for j, ans_list in kept.items():
        for ans in ans_list:
            d = differences(ans, refs[j])
            for k, v in d.items():
                total[k] += v
            failed += any(d.values())
            answers += 1
            entries += int(np.asarray(refs[j]["open_idx"]).size) * 2
    return {**total, "failed": failed, "answers": answers, "entries": entries}
