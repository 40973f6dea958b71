"""Persistent launch-parameter winner cache (stdlib only).

Counterpart of ``repro.tune.cache``, with the same schema, key fields,
bucketing, nearest-bucket rule and file format: a file either package
writes loads in the other. One JSON file holds every swept winner, keyed by
``(device_kind, backend, dim, k, shape_bucket)``:

  * ``device_kind`` — ``torch.cuda.get_device_name()`` of the device, or
    ``"cpu"`` (what the reference's ``jax.devices()[0].device_kind`` says on
    the CPU), so parameters tuned on one card never leak onto another;
  * ``backend``     — registry name (``kernel_mxu``, ``fused_mxu``, ...)
    or the pseudo-backend ``rescore`` for the prefix-rescore
    ``row_bucket`` base;
  * ``dim`` / ``k`` — HV width and static top-k (0 where not applicable);
  * ``shape_bucket`` — pow2-ceiled ``q{Q}xr{R}`` of the hot call's row
    extents, so one sweep covers the neighbourhood of shapes the serving
    path actually dispatches.

Entries carry the winning ``tiles`` dict (the port's launch parameters:
``waves`` / ``min_split_rows``, ``ctas_per_sm``, ``row_bucket``; keys
written by the reference, ``q_tile`` and the like, are ignored at dispatch)
plus the sweep evidence
(median_us, roofline_frac, git_rev). Loading is tolerant: a missing file,
unreadable JSON, a schema mismatch, or a malformed entry degrades to a
cache miss — a stale cache must never break dispatch.

The module-level runtime (``set_cache_path`` / ``lookup_tiles`` /
``cache_stats``) is what backend dispatch uses: the file named by
``set_cache_path`` or the ``REPRO_TUNE_CACHE`` env var is loaded lazily
on the first lookup and memoized; hits and misses are counted so the
launcher can report whether a tuned cache was actually picked up.
"""
from __future__ import annotations

import json
import os
import tempfile

SCHEMA = 1
ENV_VAR = "REPRO_TUNE_CACHE"

_KEY_FIELDS = ("device_kind", "backend", "dim", "k", "shape_bucket")
_REQUIRED = _KEY_FIELDS + ("tiles",)


def _pow2_ceil(n: int) -> int:
    n = max(int(n), 1)
    b = 1
    while b < n:
        b <<= 1
    return b


def shape_bucket(q_rows: int, r_rows: int) -> str:
    """Pow2-ceiled shape key, e.g. (16, 3000) -> ``q16xr4096``."""
    return f"q{_pow2_ceil(q_rows)}xr{_pow2_ceil(r_rows)}"


def _parse_bucket(bucket: str) -> tuple[int, int] | None:
    try:
        qs, rs = bucket.split("x")
        return int(qs[1:]), int(rs[1:])
    except (ValueError, IndexError):
        return None


def _entry_key(e: dict) -> tuple:
    return tuple(e[f] for f in _KEY_FIELDS)


class TuneCache:
    """In-memory view of one winner-cache file."""

    def __init__(self, entries: dict[tuple, dict] | None = None):
        self.entries: dict[tuple, dict] = dict(entries or {})

    @classmethod
    def load(cls, path: str | os.PathLike) -> "TuneCache":
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return cls()
        if not isinstance(data, dict) or data.get("schema") != SCHEMA:
            return cls()
        entries: dict[tuple, dict] = {}
        for e in data.get("entries", ()):
            if not isinstance(e, dict):
                continue
            if any(f not in e for f in _REQUIRED):
                continue
            if not isinstance(e["tiles"], dict) or not e["tiles"]:
                continue
            entries[_entry_key(e)] = e
        return cls(entries)

    def save(self, path: str | os.PathLike) -> None:
        data = {"schema": SCHEMA,
                "entries": [self.entries[k] for k in sorted(self.entries)]}
        d = os.path.dirname(os.fspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def put(self, *, device_kind: str, backend: str, dim: int, k: int,
            shape_bucket: str, tiles: dict, **evidence) -> dict:
        e = {"device_kind": device_kind, "backend": backend,
             "dim": int(dim), "k": int(k), "shape_bucket": shape_bucket,
             "tiles": {n: int(v) for n, v in tiles.items()}, **evidence}
        self.entries[_entry_key(e)] = e
        return e

    def lookup(self, device_kind: str, backend: str, dim: int, k: int,
               bucket: str) -> dict | None:
        """Exact-key hit -> the winning tiles dict, else None."""
        e = self.entries.get((device_kind, backend, int(dim), int(k), bucket))
        return dict(e["tiles"]) if e else None

    def lookup_nearest(self, device_kind: str, backend: str, dim: int,
                       k: int, q_rows: int, r_rows: int) -> dict | None:
        """Exact shape-bucket hit, else the nearest swept bucket for the
        same (device, backend, dim, k) — nearest by log2 distance over the
        (q, r) bucket pair, ties broken on the bucket string (deterministic
        so steady-state dispatch never flip-flops between entries)."""
        want = shape_bucket(q_rows, r_rows)
        hit = self.lookup(device_kind, backend, dim, k, want)
        if hit is not None:
            return hit
        wq, wr = _parse_bucket(want)
        cands = []
        for key, e in self.entries.items():
            if key[:4] != (device_kind, backend, int(dim), int(k)):
                continue
            got = _parse_bucket(e["shape_bucket"])
            if got is None:
                continue
            dist = (abs(got[0].bit_length() - wq.bit_length())
                    + abs(got[1].bit_length() - wr.bit_length()))
            cands.append((dist, e["shape_bucket"], e))
        if not cands:
            return None
        cands.sort(key=lambda c: (c[0], c[1]))
        return dict(cands[0][2]["tiles"])


# ---------------------------------------------------------------------------
# Dispatch-side runtime: lazy singleton + hit accounting
# ---------------------------------------------------------------------------

_state: dict = {"path": None, "cache": None, "hits": 0, "misses": 0}


def set_cache_path(path: str | os.PathLike | None) -> None:
    """Point dispatch at a winner-cache file (None reverts to the env var).
    Resets the loaded view and the hit/miss counters."""
    _state.update(path=os.fspath(path) if path is not None else None,
                  cache=None, hits=0, misses=0)


def cache_path() -> str | None:
    return _state["path"] if _state["path"] is not None \
        else (os.environ.get(ENV_VAR) or None)


def reset_runtime() -> None:
    """Drop the loaded cache view and counters (tests; env changes)."""
    _state.update(path=None, cache=None, hits=0, misses=0)


def _loaded() -> TuneCache | None:
    if _state["cache"] is None:
        p = cache_path()
        _state["cache"] = TuneCache.load(p) if p else TuneCache()
    return _state["cache"]


def lookup_tiles(device_kind: str, backend: str, dim: int, k: int,
                 q_rows: int, r_rows: int) -> dict | None:
    """Runtime lookup used at backend dispatch (None = use defaults)."""
    if cache_path() is None:
        return None
    tiles = _loaded().lookup_nearest(device_kind, backend, dim, k,
                                     q_rows, r_rows)
    if tiles is None:
        _state["misses"] += 1
    else:
        _state["hits"] += 1
    return tiles


def cache_stats() -> dict:
    c = _state["cache"]
    return {"path": cache_path(), "hits": _state["hits"],
            "misses": _state["misses"],
            "entries": len(c.entries) if c is not None else 0}
