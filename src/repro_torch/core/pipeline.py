"""End-to-end OMS pipeline: preprocess -> encode -> block -> search -> FDR.

Counterpart of the resident half of ``repro.core.pipeline``: the paper's
Fig. 1b flow on a library held on the device. ``OMSPipeline(cfg, refs)``
encodes the library and its row-keyed decoys chunk by chunk, merges the
(charge, pmz)-sorted chunks into the blocked DB and uploads it once;
``search`` encodes queries and runs the blocked dual-window search (or,
with ``prefix_words``, the dimension cascade) and the target-decoy FDR
filter.

The pipeline runs on the card unless the caller passes ``device="cpu"``
(the tests do); without a GPU, ``device=None`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import decoys as decoys_mod
from repro_torch.core import encode_backends, encoding, rng
from repro_torch.core.blocking import (LibraryRun, ReferenceDB,
                                       build_reference_db_from_runs)
from repro_torch.core.fdr import FDRResult, fdr_filter
from repro_torch.core.search import (SearchParams, SearchResult, oms_search,
                                     plan_search)
from repro_torch.data.spectra import SpectraSet

# Library-run kinds (the reference's store format names).
TARGET = "target"
DECOY = "decoy"


@dataclasses.dataclass(frozen=True)
class OMSConfig:
    """Paper settings (Tables I & II); fields and defaults as the reference."""

    dim: int = 4096              # Dhv
    n_levels: int = 32           # intensity quantisation levels
    bin_size: float = 0.05       # m/z bin width
    mz_min: float = 200.0
    mz_max: float = 2000.0
    max_r: int = 4096            # MAX_R reference block size
    q_block: int = 16            # Q_BLOCK
    ppm_tol: float = 20.0        # standard search window
    open_tol_da: float = 75.0    # open search window
    fdr_threshold: float = 0.01
    add_decoys: bool = True
    backend: str = "vpu"         # any name in repro_torch.core.backends.names()
    top_k: int = 1               # ranked winners per query and window
    prefix_words: int = 0        # dimension cascade (0 = full-width scan)
    prefix_margin: int = -1
    prefix_seed_da: float = 1.0
    encode_backend: str = "word_tiled"   # any encode_backends.names() entry
    encode_batch: int = 512      # spectra per encode chunk (memory bound)
    seed: int = 0

    @property
    def n_bins(self) -> int:
        return int(round((self.mz_max - self.mz_min) / self.bin_size))

    @property
    def n_words(self) -> int:
        return self.dim // 32

    @property
    def preprocess_params(self) -> encoding.PreprocessParams:
        return encoding.PreprocessParams(
            bin_size=self.bin_size, mz_min=self.mz_min, mz_max=self.mz_max,
            n_levels=self.n_levels)


class OMSOutput(NamedTuple):
    result: SearchResult       # raw dual-window matches (idx into target lib)
    open_fdr: FDRResult        # FDR filtering over the open-search matches
    std_fdr: FDRResult         # FDR filtering over the standard-search matches


def _derive_keys(cfg: OMSConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(codebook key, decoy key) from the config seed, as the reference."""
    k_cb, k_dec = rng.split(rng.PRNGKey(cfg.seed, device=device))
    return k_cb, k_dec


def _make_codebooks(cfg: OMSConfig, device) -> encoding.Codebooks:
    k_cb, _ = _derive_keys(cfg, device)
    return encoding.make_codebooks(k_cb, n_bins=cfg.n_bins,
                                   n_levels=cfg.n_levels, dim=cfg.dim)


def _encode_library_runs(
    cfg: OMSConfig, codebooks: encoding.Codebooks, k_dec: torch.Tensor,
    refs: SpectraSet, *, encode_batch: int, chunk_rows: int,
    tgt_offset: int = 0,
) -> Iterator[tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Chunked library encode on the codebooks' device.

    Yields ``(kind, hvs, pmz, charge, tgt_idx)`` host chunks — every target
    chunk, then every decoy chunk — each sorted by (charge, pmz), i.e. a
    merge run. Per-row determinism makes the output independent of the
    chunk and batch boundaries.
    """
    dev = codebooks.device
    n = refs.mz.shape[0]
    kinds = (TARGET, DECOY) if cfg.add_decoys else (TARGET,)
    for kind in kinds:
        for s in range(0, n, chunk_rows):
            e = min(s + chunk_rows, n)
            mz = torch.as_tensor(refs.mz[s:e], device=dev)
            inten = torch.as_tensor(refs.intensity[s:e], device=dev)
            if kind == DECOY:
                mz, inten = decoys_mod.make_decoy_peaks(
                    k_dec, mz, inten, cfg.mz_min, cfg.mz_max,
                    row_offset=tgt_offset + s)
            hvs_t, pmz_t, charge_t = encode_backends.preprocess_encode(
                mz, inten, refs.pmz[s:e], refs.charge[s:e], codebooks,
                cfg.preprocess_params, backend=cfg.encode_backend,
                batch=encode_batch)
            hvs = hvs_t.cpu().numpy()
            pmz = pmz_t.cpu().numpy()
            charge = charge_t.cpu().numpy()
            order = np.lexsort((pmz, charge))
            tgt_idx = (tgt_offset + s + order).astype(np.int32)
            yield kind, hvs[order], pmz[order], charge[order], tgt_idx


class OMSPipeline:
    """Stateful pipeline: holds the codebooks and the blocked reference DB
    on ``device`` (``None`` -> CUDA, raising without a GPU)."""

    def __init__(self, cfg: OMSConfig, refs: SpectraSet, *, device=None,
                 encode_batch: int | None = None, chunk_rows: int = 4096):
        self.device = resolve_device(device)
        encode_batch = cfg.encode_batch if encode_batch is None else encode_batch
        self.cfg = cfg
        _, k_dec = _derive_keys(cfg, self.device)
        self.codebooks = _make_codebooks(cfg, self.device)

        # orig_idx in the DB refers to the concatenated (targets ++ decoys)
        # layout; targets keep their library index, decoys get n_targets + i.
        self.n_targets = int(refs.mz.shape[0])
        runs = []
        for kind, hvs, pmz, charge, tgt_idx in _encode_library_runs(
                cfg, self.codebooks, k_dec, refs,
                encode_batch=encode_batch, chunk_rows=chunk_rows):
            is_d = kind == DECOY
            orig = tgt_idx + (np.int32(self.n_targets) if is_d else np.int32(0))
            runs.append(LibraryRun(hvs, pmz, charge,
                                   np.full((len(pmz),), is_d), orig))
        self.db: ReferenceDB = build_reference_db_from_runs(
            runs, max_r=cfg.max_r, device=self.device)
        self._host_sidecars_cache = None
        self._prefix_hvs: dict[int, torch.Tensor] = {}

    @property
    def _host_sidecars(self) -> tuple[np.ndarray, np.ndarray]:
        """(pmz, charge) row sidecars as host numpy, fetched once: the
        dimension cascade's seed planning should not pay a library-sized
        device-to-host copy per call."""
        if self._host_sidecars_cache is None:
            self._host_sidecars_cache = (self.db.pmz.cpu().numpy(),
                                         self.db.charge.cpu().numpy())
        return self._host_sidecars_cache

    def prefix_hvs(self, prefix_words: int) -> torch.Tensor:
        """Contiguous (n_rows, prefix_words) copy of the DB's leading words,
        made once per width (the kernels take no strided column slice)."""
        if prefix_words not in self._prefix_hvs:
            self._prefix_hvs[prefix_words] = (
                self.db.hvs[:, :prefix_words].contiguous())
        return self._prefix_hvs[prefix_words]

    def encode_queries(self, queries: SpectraSet
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return encode_backends.preprocess_encode(
            queries.mz, queries.intensity, queries.pmz, queries.charge,
            self.codebooks, self.cfg.preprocess_params,
            backend=self.cfg.encode_backend, batch=self.cfg.encode_batch)

    def search_params(self, q_pmz, q_charge, *, exhaustive=False,
                      open_tol_da=None, backend=None, top_k=None,
                      prefix_words=None, prefix_margin=None,
                      prefix_seed_da=None) -> SearchParams:
        tol = self.cfg.open_tol_da if open_tol_da is None else open_tol_da
        k = plan_search(self.db, np.asarray(q_pmz), np.asarray(q_charge),
                        open_tol_da=tol, q_block=self.cfg.q_block)
        return SearchParams(
            ppm_tol=self.cfg.ppm_tol, open_tol_da=tol,
            q_block=self.cfg.q_block, k_blocks=k,
            backend=backend or self.cfg.backend, exhaustive=exhaustive,
            top_k=self.cfg.top_k if top_k is None else top_k,
            prefix_words=(self.cfg.prefix_words if prefix_words is None
                          else prefix_words),
            prefix_margin=(self.cfg.prefix_margin if prefix_margin is None
                           else prefix_margin),
            prefix_seed_da=(self.cfg.prefix_seed_da if prefix_seed_da is None
                            else prefix_seed_da))

    def search_encoded(self, hvs: torch.Tensor, q_pmz: torch.Tensor,
                       q_charge: torch.Tensor, *, exhaustive: bool = False,
                       open_tol_da: float | None = None,
                       backend: str | None = None,
                       top_k: int | None = None,
                       prefix_words: int | None = None,
                       prefix_margin: int | None = None,
                       stats: dict | None = None) -> OMSOutput:
        """Search already-encoded query HVs. ``stats``, when given, receives
        the dimension cascade's stage counts and times."""
        # One host copy of the query sidecars, shared by plan_search and the
        # padding plan.
        qp_np = q_pmz.cpu().numpy()
        qc_np = q_charge.cpu().numpy()
        params = self.search_params(qp_np, qc_np, exhaustive=exhaustive,
                                    open_tol_da=open_tol_da, backend=backend,
                                    top_k=top_k, prefix_words=prefix_words,
                                    prefix_margin=prefix_margin)
        cascade = {}
        if params.prefix_words:
            row_pmz, row_charge = self._host_sidecars
            cascade = dict(row_pmz_np=row_pmz, row_charge_np=row_charge,
                           prefix_hvs=self.prefix_hvs(params.prefix_words),
                           stats=stats)
        result = oms_search(self.db, hvs, q_pmz, q_charge, params,
                            dim=self.cfg.dim, q_pmz_np=qp_np,
                            q_charge_np=qc_np, **cascade)

        def _fdr(row, sim):
            valid = row >= 0
            isd = self.db.is_decoy[row.clamp(0, self.db.n_rows - 1).long()] & valid
            return fdr_filter(sim.to(torch.float32), isd, valid,
                              threshold=self.cfg.fdr_threshold)

        open_fdr = _fdr(result.open_row, result.open_sim)
        std_fdr = _fdr(result.std_row, result.std_sim)
        return OMSOutput(result=result, open_fdr=open_fdr, std_fdr=std_fdr)

    def search(self, queries: SpectraSet, *, exhaustive: bool = False,
               open_tol_da: float | None = None,
               backend: str | None = None,
               top_k: int | None = None,
               prefix_words: int | None = None,
               prefix_margin: int | None = None) -> OMSOutput:
        hvs, q_pmz, q_charge = self.encode_queries(queries)
        return self.search_encoded(hvs, q_pmz, q_charge,
                                   exhaustive=exhaustive,
                                   open_tol_da=open_tol_da, backend=backend,
                                   top_k=top_k, prefix_words=prefix_words,
                                   prefix_margin=prefix_margin)

    def identifications(self, out: OMSOutput) -> int:
        return int(out.open_fdr.n_accepted)
