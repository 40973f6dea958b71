"""Carry state between the reference and the port as numpy arrays.

Packed HVs travel as uint32 (the reference's dtype) and live in the port as
int32 tensors with the same bit patterns. Nothing here imports the
reference package: callers hand over ``np.asarray`` of its arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.blocking import ReferenceDB, reference_db_from_arrays
from repro_torch.core.cascade import CascadeOutput
from repro_torch.core.encoding import Codebooks
from repro_torch.core.fdr import FDRResult
from repro_torch.core.search import SearchResult


def packed_to_torch(words, device="cpu") -> torch.Tensor:
    """uint32 (or int32) packed words -> int32 tensor, same bits."""
    a = np.ascontiguousarray(words)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=True)).to(device)


def packed_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 packed-word tensor -> uint32 numpy array, same bits."""
    return words.cpu().numpy().view(np.uint32)


def codebooks_from_reference(id_hvs, level_hvs, tiebreak, dim: int,
                             device="cpu") -> Codebooks:
    return Codebooks(id_hvs=packed_to_torch(id_hvs, device),
                     level_hvs=packed_to_torch(level_hvs, device),
                     tiebreak=packed_to_torch(tiebreak, device), dim=int(dim))


def reference_db_from_numpy(hvs, pmz, charge, is_decoy, orig_idx, block_min,
                            block_max, block_charge, *, max_r: int,
                            device="cpu") -> ReferenceDB:
    return reference_db_from_arrays(
        np.asarray(hvs), pmz, charge, is_decoy, orig_idx, block_min,
        block_max, block_charge, max_r=max_r, device=device)


def search_result_to_numpy(res: SearchResult) -> dict[str, np.ndarray]:
    return {f: getattr(res, f).cpu().numpy() for f in SearchResult._fields}


def fdr_result_to_numpy(res: FDRResult) -> dict[str, np.ndarray]:
    return {f: getattr(res, f).cpu().numpy() for f in FDRResult._fields}


def stream_stats_to_numpy(st) -> dict[str, int] | None:
    """A serve StreamStats (or TotalStats) as plain ints by field name;
    None stays None."""
    if st is None:
        return None
    d = st._asdict() if hasattr(st, "_asdict") else dataclasses.asdict(st)
    return {f: int(v) for f, v in d.items()}


def cascade_output_to_numpy(out: CascadeOutput) -> dict:
    """A CascadeOutput as nested dicts of numpy arrays and ints: the merged
    result, both FDR results, ``identified_stage1``, the totals and, per
    stage (None when it did not run), its query indices, result, FDR,
    scanned rows and stream stats."""
    def stage(st):
        if st is None:
            return None
        return {"query_idx": np.asarray(st.query_idx),
                "result": search_result_to_numpy(st.result),
                "fdr": fdr_result_to_numpy(st.fdr),
                "scanned_rows": int(st.scanned_rows),
                "stream_stats": stream_stats_to_numpy(st.stream_stats)}

    return {"result": search_result_to_numpy(out.result),
            "open_fdr": fdr_result_to_numpy(out.open_fdr),
            "std_fdr": fdr_result_to_numpy(out.std_fdr),
            "identified_stage1": np.asarray(out.identified_stage1),
            "scanned_rows_total": int(out.scanned_rows_total),
            "scanned_bytes_total": out.scanned_bytes_total,
            "stage1": stage(out.stage1), "stage2": stage(out.stage2)}
