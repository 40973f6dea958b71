"""The least time an H100 could take for one MS run's dual-window scan.

A corrected copy of ``fused_roofline`` in ``src/repro_torch/utils/roofline.py``
at commit 0d012dd. That function counts the pairs the blocked scan of this
implementation visits (``n_queries * rk``); here the work is what the inputs
need, whatever implements the search, so that a scan that skips needless
rows still reads at most 100%:

* operations: the pairs to score, the sum over queries of the library rows
  (decoys included) of the query's charge whose precursor lies within the
  open window, ``|q - r| <= open_tol_da``; the standard window lies inside
  it. A pair is ``dim`` bits, priced on the cheapest Hamming route, the
  binary tensor cores: one ``mma.sync`` m16n8k256 AND-popc scores 16 x 8
  pairs x 256 bits, and an SM issues ``BMMA_PER_CLK_SM`` of them a clock
  (measured on the H100 by ``scripts/bmma_probe.py``; NVIDIA publishes no
  binary rate for the H100). The rate is that times the SMs times the
  card's own maximum SM clock;
* bytes: the distinct library rows in the union of all windows, read once
  (packed words, float32 precursor, int32 charge), the queries once (the
  same), and the four (Q, k) int32 outputs written once, at the HBM3 rate;
* bound: the larger of the two times.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM5 datasheet
BMMA_PER_CLK_SM = 0.589            # m16n8k256 b1 MMAs per clock per SM
BMMA_PAIR_BITS = 16 * 8 * 256


class Library:
    """The library's precursors (every row, decoys included), sorted once
    by charge, for the work of many runs."""

    def __init__(self, lib_pmz, lib_charge):
        pmz = np.asarray(lib_pmz, np.float64)
        charge = np.asarray(lib_charge)
        self.by_charge = {int(c): np.sort(pmz[charge == c]) for c in np.unique(charge)}

    def window_work(self, q_pmz, q_charge, open_tol_da: float) -> tuple[int, int]:
        """(pairs, distinct rows) of one run: the pairs (query, row) with
        equal charge and ``|q - r| <= open_tol_da`` in exact arithmetic on
        the float32 values, and the number of rows inside at least one
        query's window."""
        qp = np.asarray(q_pmz, np.float64)
        qc = np.asarray(q_charge)
        pairs = rows = 0
        for c, r in self.by_charge.items():
            q = np.sort(qp[qc == c])
            if q.size == 0:
                continue
            lo = np.searchsorted(r, q - open_tol_da, side="left")
            hi = np.searchsorted(r, q + open_tol_da, side="right")
            pairs += int((hi - lo).sum())
            # the windows of sorted queries have ascending starts and ends:
            # each adds the rows past the end of the one before it
            prev = np.concatenate([[0], hi[:-1]])
            rows += int(np.maximum(hi - np.maximum(lo, prev), 0).sum())
        return pairs, rows


def bound(pairs: int, rows: int, n_queries: int, *, dim: int, top_k: int,
          n_sms: int, clock_hz: float) -> dict:
    """The operations and bytes bounds of one run, in seconds, and which
    one binds."""
    n_words = dim // 32
    t_ops = pairs * dim / BMMA_PAIR_BITS / (BMMA_PER_CLK_SM * n_sms * clock_hz)
    nbytes = (rows + n_queries) * (n_words * 4 + 8) + 4 * n_queries * top_k * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"ops_s": t_ops, "bytes_s": t_bytes, "bound_s": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes"}
