"""Autotune subsystem: per-device launch-parameter sweeps with a persistent
winner cache.

Counterpart of ``repro.tune``. Three layers, resolved by :func:`tiles_for`
at backend dispatch:

  1. kernel defaults — the constants the kernel wrappers export
     (``FUSED_WAVES`` / ``MIN_SPLIT_ROWS`` of the fused kernels, the tile
     kernels' occupancy fill ``ctas_per_sm = 0``, and
     ``DEFAULT_ROW_BUCKET_LO``);
  2. :data:`repro_torch.tune.promoted.PROMOTED` — reviewed per-device-kind
     constants, committed in the repo;
  3. the on-disk JSON winner cache (:mod:`repro_torch.tune.cache`) —
     whatever ``oms.py tune`` measured on this machine, keyed by
     ``(device_kind, backend, dim, k, shape_bucket)``.

The port's kernels take no Pallas tiles: ``QT`` and ``GROUP`` are
compile-time constants of the CUDA sources. What is tuned is what the
wrappers decide at run time — the fused kernels' split count (``waves``,
``min_split_rows``), the tile kernels' grid (``ctas_per_sm``) and the
cascade's survivor bucket floor (``row_bucket``). Every value gives
bit-identical results. Keys the port does not take (the reference's
``q_tile`` / ``r_tile`` / ``word_tile``) are ignored, so a cache written by
the reference changes no launch here.

``repro_torch.core.backends`` routes both its launch parameters and its
``peak_intermediate`` contract bounds through :func:`tiles_for`, so a tuned
value moves the declared bound with the launch.

The sweep harness lives in :mod:`repro_torch.tune.sweep` (imported lazily
by the CLI; it pulls in the kernels and the search orchestrator).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.tune.cache import (ENV_VAR, SCHEMA, TuneCache, cache_path,
                                    cache_stats, lookup_tiles, reset_runtime,
                                    set_cache_path, shape_bucket)
from repro_torch.tune.promoted import (DEFAULT_ROW_BUCKET_LO, PROMOTED,
                                       declared_tiles)

__all__ = [
    "ENV_VAR", "SCHEMA", "TuneCache", "cache_path", "cache_stats",
    "lookup_tiles", "reset_runtime", "set_cache_path", "shape_bucket",
    "DEFAULT_ROW_BUCKET_LO", "PROMOTED", "declared_tiles",
    "device_kind", "kernel_defaults", "tiles_for", "row_bucket_lo",
    "SWEPT_BACKENDS",
]

# Backends the sweep harness knows how to benchmark. "rescore" is the
# pseudo-backend for the prefix-rescore row_bucket base.
SWEPT_BACKENDS = ("kernel_vpu", "kernel_mxu", "fused", "fused_mxu",
                  "rescore")

# Smallest value each launch parameter may take.
_MINIMUM = {"waves": 1, "min_split_rows": 1, "ctas_per_sm": 0,
            "row_bucket": 1}


def device_kind(device=None) -> str:
    """The cache's device key: ``torch.cuda.get_device_name`` of the
    resolved device (``None`` -> ``cuda``, raising without a GPU), and
    ``"cpu"`` on the CPU, as the reference's ``device_kind`` reads there."""
    if device is None:
        from repro_torch._device import resolve_device
        device = resolve_device(None)
    return _device_kind(str(device))


@functools.lru_cache(maxsize=None)
def _device_kind(device: str) -> str:
    dev = torch.device(device)
    return "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)


def kernel_defaults(backend: str) -> dict[str, int]:
    """The wrappers' own launch parameters for one tunable backend (lazy
    kernel import so this module stays cheap)."""
    if backend in ("fused", "fused_mxu"):
        from repro_torch.kernels.hamming import ops as hops
        return {"waves": hops.FUSED_WAVES,
                "min_split_rows": hops.MIN_SPLIT_ROWS}
    if backend in ("kernel_vpu", "kernel_mxu"):
        return {"ctas_per_sm": 0}
    if backend == "rescore":
        return {"row_bucket": DEFAULT_ROW_BUCKET_LO}
    raise ValueError(f"backend {backend!r} is not tunable; "
                     f"swept backends: {', '.join(SWEPT_BACKENDS)}")


def _overlay(tiles: dict, extra: dict | None, source: str) -> None:
    """Take the keys of ``extra`` that ``tiles`` has; raise on a value below
    its minimum (a bad entry is an error, never silently replaced)."""
    for name, value in (extra or {}).items():
        if name not in tiles:
            continue
        if not isinstance(value, int) or value < _MINIMUM[name]:
            raise ValueError(f"{source}: {name}={value!r} is not an integer "
                             f">= {_MINIMUM[name]}")
        tiles[name] = value


def tiles_for(backend: str, *, dim: int, k: int, q_rows: int, r_rows: int,
              device=None) -> dict[str, int]:
    """Effective launch parameters of one hot call on ``device``: defaults,
    overlaid with any promoted per-device constants, overlaid with any
    cached sweep winner. Pure for a fixed loaded cache."""
    tiles = dict(kernel_defaults(backend))
    promoted = any(b == backend for _, b in PROMOTED)
    if not promoted and cache_path() is None:
        return tiles            # nothing to overlay: no device lookup needed
    dk = device_kind(device)
    _overlay(tiles, declared_tiles(dk, backend), f"PROMOTED[{dk!r}, {backend!r}]")
    _overlay(tiles, lookup_tiles(dk, backend, dim, k, q_rows, r_rows),
             f"tune cache {cache_path()}")
    return tiles


def row_bucket_lo(device=None) -> int:
    """Tuned pow2 floor for ``core.search.row_bucket`` (the prefix-rescore
    candidate-bucket base); shape-independent, keyed dim=k=0."""
    return tiles_for("rescore", dim=0, k=0, q_rows=0, r_rows=0,
                     device=device)["row_bucket"]
