"""Slab planning over a store's merged layout (counterpart of
``repro.serve.slabs``; host numpy throughout).

RapidOMS streams the packed reference library past the compute engine from
near-storage; the library is never resident. The pieces:

  * :class:`StoreLayout` — the (charge, pmz)-merged, block-padded layout of
    a library as sidecars only (pmz/charge/decoy/orig + block metadata)
    plus a per-row (run, row) gather plan for the packed HVs, which stay in
    the memory-mapped shard files until a slab needs them;
  * :func:`plan_slabs` — cuts the layout's blocks into fixed-size slabs of
    ``slab_blocks`` whole blocks (the tail slab is padded), so every slab
    has the same device shape;
  * :func:`slabs_touched` — the slabs some query's open window reaches;
  * :func:`slab_arrays` — slab ``s`` as host arrays, ready for upload.

Row-space invariant: slab ``s`` covers padded rows
``[s*slab_blocks*max_r, (s+1)*slab_blocks*max_r)`` of the same layout the
resident ``ReferenceDB`` has (the padding plan is shared code), so per-slab
winner rows offset by the slab's first row land in the resident row space.
Packed words are int32 here, as everywhere in the port.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np

from repro_torch.core.blocking import (LibraryRun, ReferenceDB,
                                       block_pmz_ranges, merge_sorted_runs,
                                       padded_partition_plan, run_sort_keys)

_F32_MAX = np.float32(np.finfo(np.float32).max)

# Sorts after every real block key of core.search's monotonic key space
# (charge * 8192 + clipped pmz): tail padding blocks keyed by this charge
# keep a slab's block keys ascending for the start-row searchsorted.
PAD_BLOCK_CHARGE = 1023


def _int32_words(hvs) -> np.ndarray:
    """Packed words as int32 bits (uint32 arrays are viewed, not copied)."""
    return hvs.view(np.int32) if hvs.dtype == np.uint32 else hvs


class StoreLayout:
    """Host merged+padded layout of a library: every ReferenceDB sidecar as
    numpy, plus a per-row (run, row) gather plan for the packed HVs."""

    def __init__(self, *, pmz, charge, is_decoy, orig_idx, block_min,
                 block_max, block_charge, src_run, src_row, hv_runs,
                 max_r: int):
        self.pmz = pmz                    # (Rp,) f32, PAD_PMZ on padding
        self.charge = charge              # (Rp,) i32, -1 on padding
        self.is_decoy = is_decoy          # (Rp,) bool
        self.orig_idx = orig_idx          # (Rp,) i32, -1 on padding
        self.block_min = block_min        # (nb,) f32
        self.block_max = block_max        # (nb,) f32
        self.block_charge = block_charge  # (nb,) i32
        self.src_run = src_run            # (Rp,) i32 — source run, -1 pad
        self.src_row = src_row            # (Rp,) i64 — row within the run
        self._hv_runs = hv_runs           # per-run (n, W) int32, may be mmap
        self.max_r = max_r

    # -- construction -------------------------------------------------------
    @classmethod
    def from_runs(cls, runs: Sequence[LibraryRun], *,
                  max_r: int) -> "StoreLayout":
        """Merge (charge, pmz)-sorted runs into the padded blocked layout
        (the sidecar half of ``build_reference_db_from_runs``) without
        touching the runs' HV payload."""
        runs = [LibraryRun(*(a if isinstance(a, np.ndarray) else np.asarray(a)
                             for a in r)) for r in runs]
        runs = [r for r in runs if len(r.pmz)]
        if not runs:
            raise ValueError("StoreLayout: no rows")
        run_id, row_in_run = merge_sorted_runs(run_sort_keys(runs))

        R = sum(len(r.pmz) for r in runs)
        pmz = np.empty((R,), np.float32)
        charge = np.empty((R,), np.int32)
        decoy = np.empty((R,), bool)
        orig = np.empty((R,), np.int32)
        # One stable argsort groups output positions by run; rows ascend.
        pos = np.argsort(run_id, kind="stable")
        bounds = np.cumsum([0] + [len(r.pmz) for r in runs])
        for i, r in enumerate(runs):
            at = pos[bounds[i]:bounds[i + 1]]
            rows = row_in_run[at]
            pmz[at] = np.asarray(r.pmz)[rows]
            charge[at] = np.asarray(r.charge)[rows]
            decoy[at] = np.asarray(r.is_decoy)[rows]
            orig[at] = np.asarray(r.orig_idx)[rows]

        sel, b_charge = padded_partition_plan(charge, max_r)
        pad = sel < 0
        idx = np.where(pad, 0, sel)
        pp = pmz[idx]
        pp[pad] = _F32_MAX
        pc = charge[idx]
        pc[pad] = -1
        pd = decoy[idx]
        pd[pad] = False
        po = orig[idx]
        po[pad] = -1
        b_min, b_max = block_pmz_ranges(pp, max_r)
        return cls(
            pmz=pp, charge=pc, is_decoy=pd, orig_idx=po,
            block_min=b_min, block_max=b_max, block_charge=b_charge,
            src_run=np.where(pad, -1, run_id[idx]).astype(np.int32),
            src_row=np.where(pad, 0, row_in_run[idx]).astype(np.int64),
            hv_runs=[_int32_words(r.hvs) for r in runs], max_r=max_r)

    @classmethod
    def from_store(cls, store: Any, *, max_r: int) -> "StoreLayout":
        """Layout of a LibraryStore: shard sidecars are read (small), shard
        HVs stay memory-mapped."""
        return cls.from_runs(list(store.iter_runs()), max_r=max_r)

    # -- introspection ------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.pmz.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.block_min.shape[0]

    @property
    def n_words(self) -> int:
        return self._hv_runs[0].shape[1]

    def sidecar_nbytes(self) -> int:
        """Host bytes held per-row (the part that is NOT slabbed)."""
        return sum(a.nbytes for a in (self.pmz, self.charge, self.is_decoy,
                                      self.orig_idx, self.src_run,
                                      self.src_row))

    # -- HV payload ---------------------------------------------------------
    def _gather(self, src, rows, W: int, out: np.ndarray) -> np.ndarray:
        out[src < 0] = 0
        for run in np.unique(src):
            if run < 0:
                continue
            m = src == run
            out[m] = self._hv_runs[run][rows[m], :W]
        return out

    def read_hv_rows(self, lo: int, hi: int, n_words: int | None = None,
                     out: np.ndarray | None = None) -> np.ndarray:
        """Packed HVs of padded rows [lo, hi) from the memory-mapped runs
        (zeros on padding rows), (hi - lo, W) int32; within a run the rows
        ascend, so shard reads stay sequential. ``n_words`` reads only that
        word prefix per row; ``out`` receives them in place."""
        W = self.n_words if n_words is None else n_words
        if out is None:
            out = np.empty((hi - lo, W), np.int32)
        return self._gather(self.src_run[lo:hi], self.src_row[lo:hi], W, out)

    def gather_rows(self, rows_padded: np.ndarray,
                    n_words: int | None = None) -> np.ndarray:
        """Packed HVs of an arbitrary ascending set of padded-layout rows
        (the cascade's seed and survivor fetches); padding rows are zero."""
        W = self.n_words if n_words is None else n_words
        out = np.empty((rows_padded.shape[0], W), np.int32)
        return self._gather(self.src_run[rows_padded],
                            self.src_row[rows_padded], W, out)

    def real_rows(self, lo: int, hi: int) -> int:
        """Non-padding layout rows in [lo, hi): the rows whose bytes a slab
        read pulls from the store shards."""
        return int((self.src_run[lo:hi] >= 0).sum())


# ---------------------------------------------------------------------------
# Slab planning
# ---------------------------------------------------------------------------


class SlabPlan(NamedTuple):
    """Fixed-size slab cut of a layout's block dimension."""

    slab_blocks: int   # whole blocks per slab (every slab, tail padded)
    n_slabs: int
    max_r: int

    @property
    def slab_rows(self) -> int:
        return self.slab_blocks * self.max_r


def plan_slabs(n_blocks: int, *, max_r: int, slab_rows: int) -> SlabPlan:
    """Round ``slab_rows`` up to whole blocks and cap at the whole store."""
    if slab_rows < 1:
        raise ValueError(f"slab_rows must be >= 1, got {slab_rows}")
    if n_blocks < 1:
        raise ValueError("plan_slabs: empty layout")
    slab_blocks = min(max(1, -(-slab_rows // max_r)), n_blocks)
    return SlabPlan(slab_blocks=slab_blocks,
                    n_slabs=-(-n_blocks // slab_blocks), max_r=max_r)


def slabs_touched(layout, q_pmz: np.ndarray, q_charge: np.ndarray, *,
                  open_tol_da: float, plan: SlabPlan) -> np.ndarray:
    """(n_slabs,) bool: does any query's open precursor window intersect any
    block of the slab? A skipped slab holds no in-window candidate (the ppm
    window lies inside the open one), so skipping keeps the result exact."""
    qp = np.asarray(q_pmz)
    qc = np.asarray(q_charge)
    bmin = np.asarray(layout.block_min)
    bmax = np.asarray(layout.block_max)
    bch = np.asarray(layout.block_charge)
    hit = np.zeros((layout.n_blocks,), bool)
    for c in np.unique(qc):
        blk = bch == c
        if not blk.any():
            continue
        m = qc == c
        lo = np.sort(qp[m] - open_tol_da)
        hi = np.sort(qp[m] + open_tol_da)
        # Block b meets some window [lo_i, hi_i] iff
        # #{i: lo_i <= bmax_b} > #{i: hi_i < bmin_b}.
        a = np.searchsorted(lo, bmax[blk], side="right")
        b = np.searchsorted(hi, bmin[blk], side="left")
        hit[blk] |= a > b
    padded = np.zeros((plan.n_slabs * plan.slab_blocks,), bool)
    padded[:layout.n_blocks] = hit
    return padded.reshape(plan.n_slabs, plan.slab_blocks).any(axis=1)


def slab_arrays(layout: StoreLayout, s: int, plan: SlabPlan,
                n_words: int | None = None,
                out: ReferenceDB | None = None) -> ReferenceDB:
    """Slab ``s`` as a host ReferenceDB of numpy arrays: the slab's rows and
    blocks of the padded layout, tail-padded to the fixed slab shape (PAD
    rows, empty blocks of charge PAD_BLOCK_CHARGE). The only place the HV
    payload is materialised — one slab's worth. ``n_words`` builds a prefix
    slab (stage A of the dimension cascade). ``out``, a ReferenceDB of
    arrays of the slab's shapes (pinned host buffers), is filled in place
    and returned."""
    b0 = s * plan.slab_blocks
    b1 = min(b0 + plan.slab_blocks, layout.n_blocks)
    if not b0 < b1:
        raise ValueError(f"slab {s} out of range (n_slabs={plan.n_slabs})")
    r0, r1 = b0 * plan.max_r, b1 * plan.max_r
    rows, nb = plan.slab_rows, plan.slab_blocks
    W = layout.n_words if n_words is None else n_words
    n, m = r1 - r0, b1 - b0
    if out is None:
        out = ReferenceDB(
            hvs=np.empty((rows, W), np.int32), pmz=np.empty((rows,), np.float32),
            charge=np.empty((rows,), np.int32), is_decoy=np.empty((rows,), bool),
            orig_idx=np.empty((rows,), np.int32),
            block_min=np.empty((nb,), np.float32),
            block_max=np.empty((nb,), np.float32),
            block_charge=np.empty((nb,), np.int32), max_r=plan.max_r)
    layout.read_hv_rows(r0, r1, n_words=W, out=out.hvs[:n])
    out.hvs[n:] = 0
    for name, fill in (("pmz", _F32_MAX), ("charge", -1), ("is_decoy", False),
                       ("orig_idx", -1)):
        dst = getattr(out, name)
        dst[:n] = getattr(layout, name)[r0:r1]
        dst[n:] = fill
    for name, fill in (("block_min", np.inf), ("block_max", -np.inf),
                       ("block_charge", PAD_BLOCK_CHARGE)):
        dst = getattr(out, name)
        dst[:m] = getattr(layout, name)[b0:b1]
        dst[m:] = fill
    return out
