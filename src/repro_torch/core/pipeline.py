"""End-to-end OMS pipeline: preprocess -> encode -> block -> search -> FDR.

Counterpart of ``repro.core.pipeline``: the paper's Fig. 1b flow, split the
way the hardware splits it.

  * **Ingest** (one-time, near-storage): ``OMSPipeline(cfg, refs)`` encodes
    the library and its row-keyed decoys chunk by chunk, merges the (charge,
    pmz)-sorted chunks into the blocked DB and uploads it once;
    ``OMSPipeline.ingest`` writes the same chunks as shards of an on-disk
    :class:`~repro_torch.store.LibraryStore` (the reference's format).
  * **Serve**: ``OMSPipeline.from_store`` cold-starts from the shards with
    no reference encoding (codebooks regenerated from the manifest seed).
    Resident, the merged DB goes to the device; with ``resident=False`` it
    never does: the streaming engine (``repro_torch.serve``) scans the store
    slab by slab, with the same results.

``search`` encodes queries and runs the blocked dual-window search (or,
with ``prefix_words``, the dimension cascade) and the target-decoy FDR
filter; ``search_cascade`` runs the narrow→open cascade
(``repro_torch.core.cascade``) on either path.

The pipeline runs on the card unless the caller passes ``device="cpu"``
(the tests do); without a GPU, ``device=None`` raises.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import decoys as decoys_mod
from repro_torch.core import encode_backends, encoding, rng
from repro_torch.core.blocking import (LibraryRun, ReferenceDB,
                                       build_reference_db_from_runs)
from repro_torch.core.cascade import (CascadeOutput, CascadeParams,
                                      cascade_search, row_match_flags)
from repro_torch.core.fdr import FDRResult, fdr_filter
from repro_torch.core.search import (SearchParams, SearchResult, _host,
                                     narrow_search_params, oms_search,
                                     plan_block_keys, plan_search,
                                     scanned_rows)
from repro_torch.data.spectra import SpectraSet
from repro_torch.obs.trace import span
from repro_torch.serve import StreamingEngine
from repro_torch.store import DECOY, TARGET, LibraryStore


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
    return _codebooks(cfg.seed, cfg.n_bins, cfg.n_levels, cfg.dim,
                      torch.device(device))


@functools.lru_cache(maxsize=4)
def _codebooks(seed: int, n_bins: int, n_levels: int, dim: int,
               device: torch.device) -> encoding.Codebooks:
    """Codebooks of one encoding config, made once per process and device
    (a store cold start, a reload and an ingest of the same config share
    them; nothing writes to them)."""
    k_cb, _ = rng.split(rng.PRNGKey(seed, device=device))
    return encoding.make_codebooks(k_cb, n_bins=n_bins, n_levels=n_levels,
                                   dim=dim)


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
    (or, streamed, the engine) on ``device`` (``None`` -> CUDA, raising
    without a GPU)."""

    def __init__(self, cfg: OMSConfig, refs: SpectraSet, *, device=None,
                 encode_batch: int | None = None, chunk_rows: int = 4096):
        self.device = resolve_device(device)
        encode_batch = cfg.encode_batch if encode_batch is None else encode_batch
        self.cfg = cfg
        self.engine = None          # set by from_store(resident=False)
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
        self._plan_keys_cache = None
        self._prefix_hvs: dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------------
    # Ingest/serve split: persistent store paths
    # ------------------------------------------------------------------
    @classmethod
    def ingest(cls, cfg: OMSConfig, refs: SpectraSet, store_path: str, *,
               device=None, encode_batch: int | None = None,
               chunk_rows: int = 4096, append: bool = False) -> LibraryStore:
        """Encode ``refs`` chunk by chunk (on ``device``, ``None`` -> CUDA)
        into an on-disk LibraryStore. Each chunk becomes a shard as soon as
        it is encoded, and the manifest is committed once, after the last
        shard. With ``append=True`` the store must exist with a matching
        config; the new references become new shards and their decoys are
        keyed by global index, so the grown store equals a one-shot build
        of the whole library."""
        dev = resolve_device(device)
        if append:
            store = LibraryStore.open(store_path)
            store.check_config(cfg)
            tgt_offset = store.n_targets
        else:
            store = LibraryStore.create(
                store_path, dim=cfg.dim, n_levels=cfg.n_levels,
                bin_size=cfg.bin_size, mz_min=cfg.mz_min, mz_max=cfg.mz_max,
                seed=cfg.seed, add_decoys=cfg.add_decoys)
            tgt_offset = 0
        _, k_dec = _derive_keys(cfg, dev)
        codebooks = _make_codebooks(cfg, dev)
        if encode_batch is None:
            encode_batch = cfg.encode_batch
        for kind, hvs, pmz, charge, tgt_idx in _encode_library_runs(
                cfg, codebooks, k_dec, refs, encode_batch=encode_batch,
                chunk_rows=chunk_rows, tgt_offset=tgt_offset):
            store.append_shard(kind, hvs, pmz, charge, tgt_idx, commit=False)
        store.commit()
        return store

    @classmethod
    def from_store(cls, store: LibraryStore | str | os.PathLike,
                   cfg: OMSConfig | None = None, *, device=None,
                   resident: bool = True, slab_rows: int = 1 << 18,
                   stream_devices=None, **overrides) -> "OMSPipeline":
        """Cold-start a serving pipeline from a persisted store, on
        ``device`` (``None`` -> CUDA). No reference is encoded: codebooks
        come from the manifest seed. A given ``cfg`` must match the store's
        encoding fields (``StoreConfigError`` otherwise); without one the
        config is the manifest's fields plus ``overrides`` (serving knobs:
        ``backend``, ``top_k``, ``max_r``, ...).

        ``resident=True`` merges the shards' sorted runs into the blocked DB
        on the device. ``resident=False`` keeps the library in the store:
        searches stream it ``slab_rows`` rows at a time through
        :class:`~repro_torch.serve.StreamingEngine`, with the same results.
        ``stream_devices`` deals the slab stream round-robin over several
        devices (see ``repro_torch.distributed.collectives``); ``device``
        then defaults to its first entry."""
        if not isinstance(store, LibraryStore):
            store = LibraryStore.open(os.fspath(store))
        if cfg is None:
            cfg = OMSConfig(**{**store.config_fields(), **overrides})
        else:
            if overrides:
                cfg = dataclasses.replace(cfg, **overrides)
            store.check_config(cfg)
        self = cls.__new__(cls)
        if device is None and stream_devices:
            device = stream_devices[0]
        self.device = resolve_device(device)
        self.cfg = cfg
        self.engine = None
        self.codebooks = _make_codebooks(cfg, self.device)
        self.n_targets = store.n_targets
        self._host_sidecars_cache = None
        self._plan_keys_cache = None
        self._prefix_hvs = {}
        if resident:
            self.db = store.load_reference_db(max_r=cfg.max_r, device=self.device)
        else:
            self.db = None
            self.engine = StreamingEngine(store, max_r=cfg.max_r,
                                          slab_rows=slab_rows,
                                          devices=stream_devices,
                                          device=self.device)
        return self

    def reload_store(self, store) -> None:
        """Hot-reload a grown (append-only) store into a streaming pipeline:
        the engine re-plans its layout and slabs (an atomic swap) and the
        host sidecar cache is dropped. Equal to a cold start on the grown
        store."""
        if self.engine is None:
            raise RuntimeError(
                "reload_store needs the streaming path (resident=False): "
                "a resident DB cannot grow in place")
        if not isinstance(store, LibraryStore):
            store = LibraryStore.open(os.fspath(store))
        store.check_config(self.cfg)
        self.engine.reload(store)
        self.n_targets = store.n_targets
        self._host_sidecars_cache = None
        self._plan_keys_cache = None

    @property
    def _block_meta(self):
        """Block metadata for host-side planning: the resident DB, or the
        streaming engine's host layout (the same arrays, numpy)."""
        return self.db if self.db is not None else self.engine.layout

    @property
    def _host_sidecars(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(pmz, charge, is_decoy) row sidecars as host numpy, fetched once:
        neither the cascade's FDR grouping nor the dimension cascade's seed
        planning should pay a library-sized device-to-host copy per call."""
        if self._host_sidecars_cache is None:
            meta = self._block_meta
            self._host_sidecars_cache = (_host(meta.pmz), _host(meta.charge),
                                         _host(meta.is_decoy))
        return self._host_sidecars_cache

    @property
    def _plan_keys(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The resident DB's block keys for the device planner
        (``search.plan_block_keys``), made once."""
        if self._plan_keys_cache is None:
            self._plan_keys_cache = plan_block_keys(self.db)
        return self._plan_keys_cache

    def prefix_hvs(self, prefix_words: int) -> torch.Tensor:
        """Contiguous (n_rows, prefix_words) copy of the DB's leading words,
        made once per width (the kernels take no strided column slice)."""
        if prefix_words not in self._prefix_hvs:
            self._prefix_hvs[prefix_words] = (
                self.db.hvs[:, :prefix_words].contiguous())
        return self._prefix_hvs[prefix_words]

    def encode_queries(self, queries: SpectraSet
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        with span("pipeline.encode", spectra=int(queries.mz.shape[0]),
                  backend=self.cfg.encode_backend):
            return encode_backends.preprocess_encode(
                queries.mz, queries.intensity, queries.pmz, queries.charge,
                self.codebooks, self.cfg.preprocess_params,
                backend=self.cfg.encode_backend, batch=self.cfg.encode_batch)

    def search_params(self, q_pmz, q_charge, *, exhaustive=False,
                      open_tol_da=None, backend=None, top_k=None,
                      prefix_words=None, prefix_margin=None,
                      prefix_seed_da=None) -> SearchParams:
        tol = self.cfg.open_tol_da if open_tol_da is None else open_tol_da
        # Query tensors on the resident DB's device are planned there.
        keys = (self._plan_keys if self.db is not None
                and isinstance(q_pmz, torch.Tensor) else None)
        k = plan_search(self._block_meta, q_pmz, q_charge, open_tol_da=tol,
                        q_block=self.cfg.q_block, block_keys=keys)
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
        the dimension cascade's stage counts and times (resident) or the
        engine's per-slab times (streamed)."""
        # The query charges go to the host once, for the padding plan; the
        # pmz only for a host reader: the streamed engine, or the dimension
        # cascade's seed plan. Resident, the planner reads the device tensors.
        resident = self.engine is None
        if prefix_words is None:
            prefix_words = self.cfg.prefix_words
        qp_np = (None if resident and not prefix_words
                 else _host(q_pmz, "sync.query.sidecars"))
        qc_np = _host(q_charge, "sync.query.sidecars")
        plan_in = (q_pmz, q_charge) if resident else (qp_np, qc_np)
        with span("pipeline.plan", queries=int(q_pmz.shape[0])):
            params = self.search_params(*plan_in, exhaustive=exhaustive,
                                        open_tol_da=open_tol_da,
                                        backend=backend, top_k=top_k,
                                        prefix_words=prefix_words,
                                        prefix_margin=prefix_margin)
        with span("pipeline.scan", backend=params.backend,
                  path="streamed" if self.engine is not None else "resident"):
            result = self._run_search(hvs, q_pmz, q_charge, params, qp_np,
                                      qc_np, stats)

        def _fdr(row, sim):
            if self.engine is None:
                valid = row >= 0
                isd = (self.db.is_decoy[row.clamp(0, self.db.n_rows - 1).long()]
                       & valid)
            else:
                # The streamed path reads the decoy flags from the host
                # layout: library-sized arrays never go to the device.
                layout = self.engine.layout
                valid, isd = (torch.from_numpy(a).to(self.device) for a in
                              row_match_flags(row, layout.is_decoy, layout.n_rows))
            return fdr_filter(sim.to(torch.float32), isd, valid,
                              threshold=self.cfg.fdr_threshold)

        with span("pipeline.fdr"):
            open_fdr = _fdr(result.open_row, result.open_sim)
            std_fdr = _fdr(result.std_row, result.std_sim)
        return OMSOutput(result=result, open_fdr=open_fdr, std_fdr=std_fdr)

    def _run_search(self, hvs, q_pmz, q_charge, params: SearchParams, qp_np,
                    qc_np, stats: dict | None = None) -> SearchResult:
        """One planned search, resident or streamed."""
        if self.engine is not None:
            return self.engine.search_encoded(
                hvs, q_pmz, q_charge, params, dim=self.cfg.dim,
                q_pmz_np=qp_np, q_charge_np=qc_np, stats=stats)
        cascade = {}
        if params.prefix_words:
            row_pmz, row_charge, _ = self._host_sidecars
            cascade = dict(row_pmz_np=row_pmz, row_charge_np=row_charge,
                           prefix_hvs=self.prefix_hvs(params.prefix_words),
                           stats=stats)
        return oms_search(self.db, hvs, q_pmz, q_charge, params,
                          dim=self.cfg.dim, q_pmz_np=qp_np, q_charge_np=qc_np,
                          **cascade)

    # ------------------------------------------------------------------
    # Cascaded narrow→open identification (see repro_torch.core.cascade)
    # ------------------------------------------------------------------
    def search_cascade_encoded(self, hvs: torch.Tensor, q_pmz: torch.Tensor,
                               q_charge: torch.Tensor, *,
                               narrow_tol_da: float = 1.0,
                               run_stage1: bool = True,
                               exhaustive: bool = False,
                               backend: str | None = None,
                               top_k: int | None = None,
                               prefix_words: int | None = None,
                               prefix_margin: int | None = None,
                               stage1_per_query: bool = False) -> CascadeOutput:
        """Two-stage cascade over an encoded query batch, resident or
        streamed: a narrow-window pass identifies unmodified spectra at the
        configured FDR and only the fall-through queries pay for the open
        scan. ``run_stage1=False`` gives :meth:`search_encoded`'s open
        search; ``stage1_per_query`` gates stage 1 per query (serve mode);
        ``prefix_words`` runs the open stage as the dimension cascade (the
        narrow stage always scans full width)."""
        qp_np = _host(q_pmz, "sync.query.sidecars")
        qc_np = _host(q_charge, "sync.query.sidecars")
        meta = self._block_meta
        k = self.cfg.top_k if top_k is None else top_k

        def run_stage(sel: np.ndarray, *, narrow: bool):
            with span("pipeline.stage", stage="narrow" if narrow else "open",
                      queries=int(len(sel))):
                qp_s, qc_s = qp_np[sel], qc_np[sel]
                if narrow:
                    # one plan_search per stage: the base params carry a
                    # placeholder k_blocks that narrow_search_params replaces
                    base = SearchParams(
                        ppm_tol=self.cfg.ppm_tol,
                        open_tol_da=self.cfg.open_tol_da,
                        q_block=self.cfg.q_block, k_blocks=1,
                        backend=backend or self.cfg.backend,
                        exhaustive=exhaustive, top_k=k)
                    params = narrow_search_params(meta, qp_s, qc_s, base,
                                                  narrow_tol_da=narrow_tol_da)
                else:
                    params = self.search_params(
                        qp_s, qc_s, exhaustive=exhaustive, backend=backend,
                        top_k=k, prefix_words=prefix_words,
                        prefix_margin=prefix_margin)
                sel_t = torch.from_numpy(sel.astype(np.int64)).to(hvs.device)
                res = self._run_search(hvs[sel_t], q_pmz[sel_t],
                                       q_charge[sel_t], params, qp_s, qc_s)
                stats = (self.engine.last_stats if self.engine is not None
                         else None)
                return res, scanned_rows(meta, len(sel), params), stats

        if run_stage1 and not narrow_tol_da < self.cfg.open_tol_da:
            raise ValueError(
                f"narrow_tol_da={narrow_tol_da!r} must be < the open window "
                f"({self.cfg.open_tol_da} Da) for the cascade to prune")
        cparams = CascadeParams(narrow_tol_da=narrow_tol_da,
                                fdr_threshold=self.cfg.fdr_threshold,
                                run_stage1=run_stage1,
                                stage1_per_query=stage1_per_query)
        row_pmz, _, row_isd = self._host_sidecars
        return cascade_search(
            run_stage, qp_np, top_k=k, row_pmz=row_pmz, row_is_decoy=row_isd,
            n_rows=meta.n_rows, params=cparams, device=self.device)

    def search_cascade(self, queries: SpectraSet, *,
                       narrow_tol_da: float = 1.0, run_stage1: bool = True,
                       exhaustive: bool = False, backend: str | None = None,
                       top_k: int | None = None,
                       stage1_per_query: bool = False) -> CascadeOutput:
        hvs, q_pmz, q_charge = self.encode_queries(queries)
        return self.search_cascade_encoded(
            hvs, q_pmz, q_charge, narrow_tol_da=narrow_tol_da,
            run_stage1=run_stage1, exhaustive=exhaustive, backend=backend,
            top_k=top_k, stage1_per_query=stage1_per_query)

    def pure_open_scanned_rows(self, n_queries: int, q_pmz, q_charge, *,
                               exhaustive: bool = False) -> int:
        """Static comparison-row count a single-stage open search of this
        batch would pay: the baseline of the cascade's
        ``scanned_rows_total``."""
        params = self.search_params(_host(q_pmz), _host(q_charge),
                                    exhaustive=exhaustive)
        return scanned_rows(self._block_meta, n_queries, params)

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
