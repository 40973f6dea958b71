"""Encoder-backend registry for the ID-Level HD encoder (paper §II-A).

Counterpart of ``repro.core.encode_backends``, with the same names and
kinds:

  name        kind    engine
  ----------  ------  -----------------------------------------------------
  oracle      encode  plain torch; materialises (batch, P, D) bits
  word_tiled  encode  plain torch, Dhv looped in word tiles
  pallas      encode  the hand-written CUDA hdencode kernel
                      (kernels/hdencode); its plain version on CPU tensors
  fused       fused   preprocess + word-tiled encode per chunk

``encode`` backends consume preprocessed spectra, ``fn(spectra, cb) ->
(B, W) int32``; ``fused`` backends consume raw peaks, ``fn(mz, intensity,
pmz, charge, cb, *, pp, batch) -> (hvs, pmz, charge)``. Every backend is
bit-identical to ``oracle``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# Dependency-free registry (stdlib only) — safe at module level.
from repro_torch.analysis.registry import declare as _declare
from repro_torch.core import encoding
from repro_torch.core.encoding import (Codebooks, PreprocessParams,
                                       PreprocessedSpectra)
from repro_torch.core.search import _upload

ENCODE = "encode"
FUSED = "fused"


@dataclasses.dataclass(frozen=True)
class EncodeBackend:
    name: str
    kind: str          # ENCODE | FUSED
    fn: Callable


_REGISTRY: dict[str, EncodeBackend] = {}


def register(name: str, kind: str, fn: Callable) -> EncodeBackend:
    if kind not in (ENCODE, FUSED):
        raise ValueError(f"encode backend kind must be {ENCODE!r} or "
                         f"{FUSED!r}, got {kind!r}")
    be = EncodeBackend(name=name, kind=kind, fn=fn)
    _REGISTRY[name] = be
    return be


def get(name: str) -> EncodeBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown encode backend {name!r}; registered: {', '.join(names())}"
        ) from None


def names(kind: str | None = None) -> tuple[str, ...]:
    return tuple(n for n, b in _REGISTRY.items()
                 if kind is None or b.kind == kind)


def _preprocess(mz, intensity, pmz, charge, pp: PreprocessParams
                ) -> PreprocessedSpectra:
    return encoding.preprocess_spectra(
        mz, intensity, pmz, charge, bin_size=pp.bin_size, mz_min=pp.mz_min,
        mz_max=pp.mz_max, n_levels=pp.n_levels,
        min_intensity_frac=pp.min_intensity_frac)


def preprocess_encode(mz, intensity, pmz, charge, cb: Codebooks,
                      pp: PreprocessParams, *, backend: str = "oracle",
                      batch: int = 512):
    """Preprocess + encode a raw spectrum batch through ``backend``.

    The single entry point the pipeline uses for queries and library chunks
    alike. Inputs (numpy or tensors) move to the codebooks' device, each
    copy inside span ``sync.encode.upload``. Returns
    ``(hvs, pmz, charge)``: hvs (B, W) int32, pmz float32, charge int32.
    """
    dev = cb.device
    mz, intensity, pmz, charge = (_upload(x, dev, "sync.encode.upload")
                                  for x in (mz, intensity, pmz, charge))
    be = get(backend)
    if be.kind == FUSED:
        return be.fn(mz, intensity, pmz, charge, cb, pp=pp, batch=batch)
    pre = _preprocess(mz, intensity, pmz, charge, pp)
    hvs = encoding.encode_spectra_batched(pre, cb, batch=batch, backend=backend)
    return hvs, pre.pmz, pre.charge


def _word_tiled(spectra: PreprocessedSpectra, cb: Codebooks):
    return encoding.encode_spectra_word_tiled(spectra, cb)


def _pallas(spectra: PreprocessedSpectra, cb: Codebooks):
    from repro_torch.kernels.hdencode import ops as eops
    return eops.hdencode(spectra.bins, spectra.levels, spectra.mask,
                         cb.id_hvs, cb.level_hvs, cb.tiebreak)


def _fused_preprocess_encode(mz, intensity, pmz, charge, cb: Codebooks, *,
                             pp: PreprocessParams, batch: int):
    """Preprocess and word-tiled encode chunk by chunk over the shared chunk
    loop. Padding rows (zero intensity) are all-masked and sliced off."""

    def one_chunk(m, i, p, c):
        pre = _preprocess(m, i, p, c, pp)
        return (encoding.encode_spectra_word_tiled(pre, cb), pre.pmz, pre.charge)

    return encoding.chunked_batch_map(one_chunk, (mz, intensity, pmz, charge),
                                      batch)


register("oracle", ENCODE, encoding.encode_spectra)
register("word_tiled", ENCODE, _word_tiled)
register("pallas", ENCODE, _pallas)
register("fused", FUSED, _fused_preprocess_encode)


# ---------------------------------------------------------------------------
# Contracts — the encode hot path's memory/transfer/dtype story, declared
# next to the registrations and machine-checked by `oms.py analyze` (the
# runner records preprocess_encode per backend; see repro_torch.analysis).
# ---------------------------------------------------------------------------

for _t in ("encode:oracle", "encode:word_tiled", "encode:pallas",
           "encode:fused"):
    _declare(_t, "no_host_transfer")
    _declare(_t, "dtype_stability")

# Largest output of one encode chunk, over the context (batch = spectra per
# chunk, peaks, dim, word_tile, n_bins). The oracle is ALLOWED its
# (B, P, W, 32) unpacked-bit tensor — that is what makes it the oracle; the
# word-tiled schedules stay word-tile-bounded: (B, P, WT, 32) int32. They
# also slice the resident ID codebook into word tiles — a view of an INPUT,
# so the codebook's own footprint is part of every bound.


def _codebook_bytes(c) -> int:
    return c["n_bins"] * c["n_words"] * 4


def _word_tile_bound(c):
    return max(c["batch"] * c["peaks"] * c["word_tile"] * 32 * 4,
               _codebook_bytes(c))


_declare("encode:oracle", "peak_intermediate",
         bound=lambda c: max(c["batch"] * c["peaks"] * c["dim"] * 4,
                             _codebook_bytes(c)),
         note="reference schedule: full (B, P, D) unpacked bits")
for _t in ("encode:word_tiled", "encode:fused"):
    _declare(_t, "peak_intermediate", bound=_word_tile_bound,
             note="word-tiled schedule: (B, P, WT*32) unpacked-bit tile "
                  "or the word-tiled codebook view")
_declare("encode:pallas", "peak_intermediate", bound=_word_tile_bound,
         note="hdencode CUDA kernel: bit-sliced counters in registers; "
              "outside-kernel intermediates stay tile-bounded")
