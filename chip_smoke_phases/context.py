"""The state the phases share: the card, the main path's dataset and
pipeline, the store, the kernels line and the launches by path. Each
resource is made on first use, by the phase that first reads it, so a run
of some phases makes only what they read."""
from __future__ import annotations

import gc
import shutil
import time
from collections import defaultdict
from pathlib import Path

from . import common as C
from .common import log


class MainPath:
    """Phase 3's main path: the pipeline and its encoded batch and result."""

    def __init__(self, pipe, hvs, q_pmz, q_charge, out):
        self.pipe, self.hvs, self.q_pmz, self.q_charge, self.out = pipe, hvs, q_pmz, q_charge, out

    @property
    def batch(self):
        return self.hvs, self.q_pmz, self.q_charge


class Context:
    def __init__(self, torch, store_dir: Path | None = None):
        self.torch = torch
        self.env = None                      # phase 1's card description
        self.kernels = {}                    # the kernels line's entries by name
        self.by_path = defaultdict(dict)     # {kernel: {path: launches}}
        self.lines = {}                      # the lm / train / dist / examples lines
        self.background = {}                 # phase name -> its side processes
        self.cli = {}                        # phase 16's outputs that phase 17 reuses
        self.bucket = None                   # phase 6's bucket-shape times for phase 10
        self.store_dir = store_dir or C.BUILD / "smoke_store"
        self._made = {}
        self._paths = []                     # files and directories removed at the end

    # -- resources --------------------------------------------------------

    def _get(self, key, make):
        if key not in self._made:
            self._made[key] = make()
        return self._made[key]

    @property
    def cfg(self):
        from repro_torch.core.pipeline import OMSConfig
        return self._get("cfg", lambda: OMSConfig(
            backend="fused", encode_backend="pallas", encode_batch=C.ENCODE_BATCH,
            seed=C.SEED))

    def data(self):
        """(LibraryConfig, dataset) of the iPRG2012 scale of Table I."""
        def make():
            from repro_torch.data.spectra import iprg2012_config, make_dataset
            t0 = time.perf_counter()
            lib_cfg = iprg2012_config(scale=1.0, seed=C.SEED)
            ds = make_dataset(lib_cfg)
            log(f"[data] iPRG2012 scale: {lib_cfg.n_refs} library spectra, "
                f"{lib_cfg.n_queries} queries, {lib_cfg.max_peaks} peaks "
                f"(numpy, seed {C.SEED}) in {time.perf_counter() - t0:.1f}s")
            return lib_cfg, ds
        return self._get("data", make)

    def main(self) -> MainPath:
        from . import oms_paths
        return self._get("main", lambda: oms_paths.ingest_main(self))

    def store(self):
        """Phase 12's store of the Table I library under ``store_dir``."""
        from . import store_stream
        return self._get("store", lambda: store_stream.ingest_store(self))

    def streamed(self):
        """The store streamed at 2^18 rows a slab."""
        from . import store_stream
        return self._get("streamed", lambda: store_stream.open_streamed(self))

    def requests(self):
        """The 16,000 request lines of ``queries`` (started if nothing has)."""
        from . import launcher
        return self._get("requests", lambda: launcher.wait_requests(self))

    def remove_later(self, *paths) -> None:
        self._paths.extend(Path(p) for p in paths)

    def release(self, key: str) -> None:
        """Drop a resource no later phase reads (and its files)."""
        if key == "store":
            shutil.rmtree(self.store_dir, ignore_errors=True)
        if key == "main":
            self._made.pop("data", None)
        if self._made.pop(key, None) is not None:
            gc.collect()
            if self.torch.cuda.is_available():
                self.torch.cuda.empty_cache()

    def close(self) -> None:
        """Stop the side processes; remove what the phases wrote."""
        C.stop_all()
        shutil.rmtree(self.store_dir, ignore_errors=True)
        for p in self._paths:
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
            else:
                p.unlink(missing_ok=True)
