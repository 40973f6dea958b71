"""On-disk sharded library store (counterpart of ``repro.store.library_store``).

RapidOMS keeps the *encoded* reference library in near-storage in packed
binary form and streams it to the compute engine at serve time; encoding is
paid once, at ingest. The store is that library as a directory, in the
reference's format byte for byte:

    store/
      manifest.json            # encoding config + shard table
      shard_00000.hvs.npy      # (rows, dim/32) uint32 — packed HVs
      shard_00000.pmz.npy      # (rows,) float32 — precursor neutral mass
      shard_00000.charge.npy   # (rows,) int32
      shard_00000.decoy.npy    # (rows,) bool
      shard_00000.orig.npy     # (rows,) int32 — index into the target library
      ...

Each shard is one ingest chunk, role-pure (all-target or all-decoy) and
sorted by (charge, pmz): a merge run. The port's packed words are int32
tensors holding the reference's uint32 bits, so HVs are written as a uint32
*view* of the int32 words and read back as an int32 view of the memory map
(no value conversion, no copy). The manifest pins the encoding config (the
codebooks are regenerated from its seed) and the shard table; it is written
last, by tmp + rename, so a crashed ingest or append leaves the store as it
was. ``append`` adds shards and never rewrites one; decoys are row-keyed and
``orig`` holds target-library indices (decoys are offset at load time), so a
store grown by appends searches exactly like a one-shot build.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Iterator

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.blocking import (LibraryRun, ReferenceDB,
                                       build_reference_db_from_runs,
                                       composite_sort_key, sort_key_offset)
from repro_torch.store.format import (CONFIG_KEYS, DECOY, FORMAT_VERSION,
                                      SIDECARS, TARGET)


class StoreError(ValueError):
    """Malformed or incompatible library store."""


class StoreConfigError(StoreError):
    """Serving config does not match the store's manifest."""


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    name: str   # file stem, e.g. "shard_00000"
    kind: str   # TARGET | DECOY
    rows: int


def _uint32_words(hvs) -> np.ndarray:
    """Packed words as contiguous uint32 with the same bits: int32 words
    are viewed, never converted."""
    hvs = np.ascontiguousarray(hvs)
    if hvs.dtype == np.int32:
        return hvs.view(np.uint32)
    if hvs.dtype != np.uint32:
        raise StoreError(f"shard HVs must be int32 or uint32 words, got {hvs.dtype}")
    return hvs


class LibraryStore:
    """Persistent sharded store of encoded (packed-HV) references."""

    def __init__(self, path: str, manifest: dict):
        self.path = str(path)
        self.manifest = manifest

    # -- lifecycle ----------------------------------------------------------
    @classmethod
    def create(cls, path: str, *, dim: int, n_levels: int, bin_size: float,
               mz_min: float, mz_max: float, seed: int,
               add_decoys: bool) -> "LibraryStore":
        os.makedirs(path, exist_ok=True)
        mpath = os.path.join(path, "manifest.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                existing = json.load(f)
            if existing.get("shards"):
                raise StoreError(f"store already exists at {path!r} "
                                 "(open it and append, or use a fresh directory)")
            # zero-shard manifest = a crashed first ingest; safe to re-init
        manifest = {
            "format_version": FORMAT_VERSION,
            "dim": int(dim), "n_levels": int(n_levels),
            "bin_size": float(bin_size),
            "mz_min": float(mz_min), "mz_max": float(mz_max),
            "seed": int(seed), "add_decoys": bool(add_decoys),
            "n_targets": 0,
            "shards": [],
        }
        store = cls(path, manifest)
        store._write_manifest()
        return store

    @classmethod
    def open(cls, path: str) -> "LibraryStore":
        mpath = os.path.join(path, "manifest.json")
        if not os.path.exists(mpath):
            raise StoreError(f"no library store at {path!r} (missing manifest.json)")
        with open(mpath) as f:
            manifest = json.load(f)
        ver = manifest.get("format_version")
        if ver != FORMAT_VERSION:
            raise StoreError(f"unsupported store format_version {ver!r} "
                             f"(this build reads {FORMAT_VERSION})")
        store = cls(path, manifest)
        store.validate()
        return store

    def _write_manifest(self) -> None:
        # Shard files first, the manifest (the commit point) last, via tmp +
        # rename: a crash leaves the old manifest and orphaned shard files,
        # which are ignored and overwritten by name on the next attempt.
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".manifest.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.manifest, f, indent=1)
            os.replace(tmp, os.path.join(self.path, "manifest.json"))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def validate(self) -> None:
        """Check that every shard file exists, that every sidecar's row count
        matches the manifest and that the HV width is ``dim/32`` (headers
        only: no data pages are read)."""
        W = self.n_words
        for s in self.shards:
            for part in SIDECARS:
                p = self._file(s.name, part)
                if not os.path.exists(p):
                    raise StoreError(f"store shard file missing: {p}")
                arr = np.load(p, mmap_mode="r")
                if arr.shape[0] != s.rows:
                    raise StoreError(
                        f"shard {s.name}: manifest says {s.rows} rows, "
                        f"{part} sidecar has {arr.shape[0]}")
                if part == "hvs" and (arr.ndim != 2 or arr.shape[1] != W):
                    got = arr.shape[1:] if arr.ndim > 1 else "scalar rows"
                    raise StoreError(
                        f"shard {s.name}: hvs width {got} != manifest "
                        f"dim/32 = {W} words")

    # -- introspection ------------------------------------------------------
    def _file(self, name: str, part: str) -> str:
        return os.path.join(self.path, f"{name}.{part}.npy")

    @property
    def shards(self) -> list[ShardInfo]:
        return [ShardInfo(**s) for s in self.manifest["shards"]]

    @property
    def n_targets(self) -> int:
        return int(self.manifest["n_targets"])

    @property
    def n_rows(self) -> int:
        return sum(s.rows for s in self.shards)

    @property
    def n_words(self) -> int:
        return int(self.manifest["dim"]) // 32

    def nbytes(self) -> int:
        """Total on-disk payload (shard files, manifest excluded)."""
        return sum(os.path.getsize(self._file(s.name, part))
                   for s in self.shards for part in SIDECARS)

    @staticmethod
    def manifest_token(path: str) -> tuple:
        """Cheap change token of the store at ``path``: the manifest's
        (mtime_ns, size). The manifest is committed by atomic rename, so a
        changed token means a fully committed generation is visible."""
        st = os.stat(os.path.join(path, "manifest.json"))
        return (st.st_mtime_ns, st.st_size)

    def config_fields(self) -> dict:
        return {k: self.manifest[k] for k in CONFIG_KEYS}

    def check_config(self, cfg) -> None:
        """Raise :class:`StoreConfigError` unless ``cfg`` (an OMSConfig) is
        encoding-compatible with this store."""
        for k in CONFIG_KEYS:
            want, got = self.manifest[k], getattr(cfg, k)
            if want != got:
                raise StoreConfigError(
                    f"store at {self.path!r} was built with {k}={want!r}, "
                    f"serving config has {k}={got!r}")

    # -- writes -------------------------------------------------------------
    def append_shard(self, kind: str, hvs: np.ndarray, pmz: np.ndarray,
                     charge: np.ndarray, orig_idx: np.ndarray, *,
                     commit: bool = True) -> ShardInfo:
        """Write one (charge, pmz)-sorted, role-pure shard and record it in
        the manifest; never touches existing shard files. ``hvs`` are int32
        (the port's words) or uint32. With ``commit=False`` the manifest on
        disk is left alone until :meth:`commit` publishes a batch of
        shards at once."""
        if kind not in (TARGET, DECOY):
            raise StoreError(f"shard kind must be {TARGET!r} or {DECOY!r}")
        hvs = _uint32_words(hvs)
        pmz = np.ascontiguousarray(pmz, dtype=np.float32)
        charge = np.ascontiguousarray(charge, dtype=np.int32)
        orig_idx = np.ascontiguousarray(orig_idx, dtype=np.int32)
        n = hvs.shape[0]
        if hvs.shape[1] != self.n_words:
            raise StoreError(f"shard HV width {hvs.shape[1]} != store "
                             f"dim/32 = {self.n_words}")
        if not (pmz.shape == charge.shape == orig_idx.shape == (n,)):
            raise StoreError("shard sidecar row counts disagree")
        key = composite_sort_key(pmz, charge,
                                 off=sort_key_offset(pmz.max(initial=0.0)))
        if np.any(np.diff(key) < 0):
            raise StoreError("shard rows must be (charge, pmz)-sorted")

        name = f"shard_{len(self.shards):05d}"
        np.save(self._file(name, "hvs"), hvs)
        np.save(self._file(name, "pmz"), pmz)
        np.save(self._file(name, "charge"), charge)
        np.save(self._file(name, "decoy"), np.full((n,), kind == DECOY))
        np.save(self._file(name, "orig"), orig_idx)
        info = ShardInfo(name=name, kind=kind, rows=n)
        self.manifest["shards"].append(dataclasses.asdict(info))
        if kind == TARGET:
            self.manifest["n_targets"] = self.n_targets + n
        if commit:
            self._write_manifest()
        return info

    def commit(self) -> None:
        """Atomically publish all staged (``commit=False``) shards."""
        self._write_manifest()

    # -- reads --------------------------------------------------------------
    def iter_runs(self, *, mmap: bool = True) -> Iterator[LibraryRun]:
        """Yield shards as sorted :class:`LibraryRun`\\ s in logical order:
        every target shard, then every decoy shard (the concatenated layout
        of an in-memory build, whatever order appends wrote them in). HVs
        are int32 views of the memory map; decoy ``orig_idx`` is offset by
        the current target count."""
        mode = "r" if mmap else None
        n_targets = self.n_targets
        ordered = ([s for s in self.shards if s.kind == TARGET]
                   + [s for s in self.shards if s.kind == DECOY])
        for s in ordered:
            orig = np.load(self._file(s.name, "orig"), mmap_mode=mode)
            if s.kind == DECOY:
                orig = np.asarray(orig) + np.int32(n_targets)
            yield LibraryRun(
                hvs=np.load(self._file(s.name, "hvs"), mmap_mode=mode).view(np.int32),
                pmz=np.load(self._file(s.name, "pmz"), mmap_mode=mode),
                charge=np.load(self._file(s.name, "charge"), mmap_mode=mode),
                is_decoy=np.load(self._file(s.name, "decoy"), mmap_mode=mode),
                orig_idx=orig,
            )

    def load_reference_db(self, *, max_r: int, device=None) -> ReferenceDB:
        """Merge the store's sorted runs into the blocked serving DB on
        ``device`` (``None`` -> CUDA): no encoding, HVs straight from the
        memory-mapped shards."""
        if not self.shards:
            raise StoreError(f"store at {self.path!r} has no shards "
                             "(empty, or a crashed first ingest)")
        return build_reference_db_from_runs(self.iter_runs(), max_r=max_r,
                                            device=resolve_device(device))
