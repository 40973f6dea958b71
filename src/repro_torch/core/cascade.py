"""Cascaded narrow→open OMS identification (two stages, HyperOMS style).

Counterpart of ``repro.core.cascade``. A cheap **narrow** pass (the open
window shrunk to ``narrow_tol_da``, so each query block scans only a few
reference blocks) identifies the unmodified spectra first; only the
fall-through queries pay for the full open scan. The stages are ordinary
searches run through a caller-supplied ``run_stage(sel, narrow=...)``
closure (the pipeline wires it to the resident ``oms_search`` or to the
streaming engine), which keeps two invariants true by construction:

  * with stage 1 off (``CascadeParams.run_stage1=False``) the output equals
    a plain open search — stage 2 *is* that search, on every query;
  * every stage-2 result equals a pure open search of the fall-through
    queries.

A query is identified at stage 1 when its rank-0 narrow match is accepted
by the target-decoy filter, pooled over the batch or, with
``stage1_per_query``, over the query's own top-k list. The merge and the
shift grouping run on the host in numpy on float32 pmz; the merged result
is FDR-filtered shift-grouped (open matches) and pooled (standard-window
matches).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.fdr import (FDRResult, fdr_filter, fdr_filter_grouped,
                                  fdr_filter_per_query)
from repro_torch.core.search import SearchResult, _host


class CascadeParams(NamedTuple):
    """Static cascade settings (stage SearchParams are planned per stage)."""

    narrow_tol_da: float = 1.0   # stage-1 open window and the FDR subgroup
    #                              boundary: |Δpmz| ≤ this is "standard"
    fdr_threshold: float = 0.01  # stage-1 identification + final filtering
    run_stage1: bool = True      # False = pure open search via the cascade
    stage1_per_query: bool = False  # stage-1 competition per query (serve)


class StageOutput(NamedTuple):
    """Provenance of one cascade stage."""

    query_idx: np.ndarray   # (Qs,) int32 — original query positions searched
    result: SearchResult    # (Qs, k) — this stage's raw matches
    fdr: FDRResult          # stage-level FDR over its open-window matches
    scanned_rows: int       # static comparison-row count this stage paid
    stream_stats: Any       # serve StreamStats when streamed, else None


class CascadeOutput(NamedTuple):
    result: SearchResult       # (Q, k) merged: stage-1 rows where identified,
    #                            stage-2 rows for the fall-through queries
    open_fdr: FDRResult        # shift-grouped FDR over the merged open matches
    std_fdr: FDRResult         # FDR over the merged standard-window matches
    identified_stage1: np.ndarray  # (Q,) bool — accepted at stage 1
    stage1: StageOutput | None
    stage2: StageOutput | None

    @property
    def scanned_rows_total(self) -> int:
        return sum(s.scanned_rows for s in (self.stage1, self.stage2)
                   if s is not None)

    @property
    def scanned_bytes_total(self) -> int | None:
        """Packed-HV bytes streamed across both stages, or None on the
        resident path (only the serve engine meters store reads)."""
        stages = [s for s in (self.stage1, self.stage2) if s is not None]
        if not stages or any(s.stream_stats is None for s in stages):
            return None
        return sum(s.stream_stats.scanned_bytes for s in stages)

    @property
    def fallthrough(self) -> np.ndarray:
        """(Q,) bool — queries that paid for the open scan."""
        return ~self.identified_stage1


# ``run_stage(sel, narrow=...)`` searches the query subset ``sel`` (int32
# positions into the batch) under the narrow or the full open window and
# returns (SearchResult, scanned_rows, stream_stats_or_None).
RunStage = Callable[..., tuple[SearchResult, int, Any]]


def row_match_flags(row, is_decoy_np: np.ndarray, n_rows: int):
    """Host (valid, is_decoy) flags for winner rows (-1 = no match); shared
    by the cascade's FDR passes and the pipeline's streamed FDR."""
    row_h = _host(row)
    valid = row_h >= 0
    isd = is_decoy_np[np.clip(row_h, 0, n_rows - 1)] & valid
    return valid, isd


def _tensors(device, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def _stage_fdr(result: SearchResult, is_decoy_np, n_rows, threshold, *,
               per_query: bool = False, device="cpu") -> FDRResult:
    valid, isd = row_match_flags(result.open_row, is_decoy_np, n_rows)
    filt = fdr_filter_per_query if per_query else fdr_filter
    sim, isd_t, valid_t = _tensors(device, _host(result.open_sim), isd, valid)
    return filt(sim.to(torch.float32), isd_t, valid_t, threshold=threshold)


def cascade_search(run_stage: RunStage, q_pmz_np: np.ndarray, *, top_k: int,
                   row_pmz: np.ndarray, row_is_decoy: np.ndarray, n_rows: int,
                   params: CascadeParams, device="cpu") -> CascadeOutput:
    """Run the two-stage cascade over one query batch.

    ``q_pmz_np`` is the host precursor-mass array; ``row_pmz`` /
    ``row_is_decoy`` the library's padded-row sidecars (host numpy). The
    merged result and the FDR results are tensors on ``device``.
    """
    if not params.narrow_tol_da > 0.0:
        raise ValueError(
            f"narrow_tol_da must be > 0, got {params.narrow_tol_da!r}")
    Q = int(np.asarray(q_pmz_np).shape[0])
    if Q == 0:
        empty = torch.full((0, top_k), -1, dtype=torch.int32, device=device)
        z = torch.zeros((0, top_k), device=device)
        no_fdr = FDRResult(z.to(torch.bool), z, torch.zeros((), dtype=torch.int32,
                                                            device=device))
        return CascadeOutput(SearchResult(*(empty,) * 6), no_fdr, no_fdr,
                             np.zeros((0,), bool), None, None)

    identified = np.zeros((Q,), bool)
    stage1 = None
    if params.run_stage1:
        all_idx = np.arange(Q, dtype=np.int32)
        res1, scanned1, stats1 = run_stage(all_idx, narrow=True)
        fdr1 = _stage_fdr(res1, row_is_decoy, n_rows, params.fdr_threshold,
                          per_query=params.stage1_per_query, device=device)
        accept1 = _host(fdr1.accept)
        # Identified at stage 1: the best (rank-0) narrow match is accepted.
        identified = accept1[:, 0] if accept1.ndim == 2 else accept1
        stage1 = StageOutput(all_idx, res1, fdr1, scanned1, stats1)

    fall_idx = np.flatnonzero(~identified).astype(np.int32)
    stage2 = None
    if fall_idx.size:
        res2, scanned2, stats2 = run_stage(fall_idx, narrow=False)
        fdr2 = _stage_fdr(res2, row_is_decoy, n_rows, params.fdr_threshold,
                          device=device)
        stage2 = StageOutput(fall_idx, res2, fdr2, scanned2, stats2)

    # Merge on the host: identified queries keep their stage-1 rows, the
    # fall-through queries get their stage-2 rows scattered back. Every
    # SearchResult field is int32, so the round trip is lossless.
    merged = {}
    for f in SearchResult._fields:
        if stage1 is not None:
            base = np.array(_host(getattr(stage1.result, f)))
        else:
            base = np.full((Q, top_k), -1, np.int32)
        if stage2 is not None:
            base[fall_idx] = _host(getattr(stage2.result, f))
        merged[f] = _tensors(device, base)[0]
    result = SearchResult(**merged)

    # Shift-grouped FDR over the merged lists: a match's subgroup is decided
    # by its own precursor shift, not by the stage that produced it.
    def _grouped(row, sim):
        valid, isd = row_match_flags(row, row_is_decoy, n_rows)
        row_h = np.clip(_host(row), 0, n_rows - 1)
        dpmz = np.abs(np.asarray(q_pmz_np, np.float32)[:, None]
                      - row_pmz[row_h])
        in_narrow = valid & (dpmz <= params.narrow_tol_da)
        sim_t, isd_t, valid_t, narrow_t = _tensors(device, _host(sim), isd,
                                                   valid, in_narrow)
        return fdr_filter_grouped(sim_t.to(torch.float32), isd_t, valid_t,
                                  narrow_t, threshold=params.fdr_threshold)

    def _plain(row, sim):
        valid, isd = row_match_flags(row, row_is_decoy, n_rows)
        sim_t, isd_t, valid_t = _tensors(device, _host(sim), isd, valid)
        return fdr_filter(sim_t.to(torch.float32), isd_t, valid_t,
                          threshold=params.fdr_threshold)

    return CascadeOutput(
        result=result,
        open_fdr=_grouped(result.open_row, result.open_sim),
        # standard-window matches are all |Δpmz| ≤ ppm ⊂ narrow: one group
        std_fdr=_plain(result.std_row, result.std_sim),
        identified_stage1=identified,
        stage1=stage1, stage2=stage2)
