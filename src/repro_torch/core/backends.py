"""Search-backend registry for the blocked OMS orchestrator.

Counterpart of ``repro.core.backends``. Two kinds:

  * ``matrix`` — ``fn(q_hvs, r_hvs, dim) -> (Qb, Rk) int32 hamming`` for one
    query block; the orchestrator applies the windows and the top-k.
  * ``fused`` — one call for the whole sorted/padded batch:
    ``fn(q_hvs, q_pmz, q_charge, r_hvs, r_pmz, r_charge, start_rows, *,
    q_block, rk, dim, k, ppm_tol, open_tol_da) -> (std_sim, std_row,
    open_sim, open_row)``, each (Qp, k) int32 with global DB rows or -1.
    The reference calls its fused kernel once per query block; the port's
    kernel takes every block's start row and covers the batch in one launch.

Built-in backends:

  name        kind    engine
  ----------  ------  -----------------------------------------------------
  vpu         matrix  packed XOR + SWAR popcount (plain torch)
  mxu         matrix  +-1 dot ``(D - x.y)/2`` (plain torch, exact float32)
  kernel_vpu  matrix  the hand-written CUDA all-pairs Hamming tile kernel
                      (kernels/hamming, popc); its plain version on CPU tensors
  kernel_mxu  matrix  the hand-written CUDA +-1 int8 tensor-core tile kernel
                      (kernels/hamming_mxu); its plain version on CPU tensors
  fused       fused   the hand-written CUDA fused search kernel
                      (kernels/hamming, popc); its plain version on CPU tensors;
                      its cascade tile is ``kernel_vpu``
  fused_mxu   fused   the hand-written CUDA fused search kernel on the int8
                      tensor cores (kernels/hamming_mxu), bit-identical to
                      ``fused``; its plain version on CPU tensors
  fused_xla   fused   the plain version of ``fused``

Matrix backends run block by block through the plain fused version
(``kernels/hamming/ref.fused_search(..., tile_fn=be.fn)``), as the
reference's ``lax.map`` does; fused backends take the whole batch in one
launch. The dimension cascade's prefix scan and survivor rescore need a raw
tile at any word width: :func:`hamming_tile_fn` routes them. The reference
sends ``fused`` to the ``vpu`` tile, which XLA fuses; in eager torch that
tile materialises a (Qb, S, W) int32 tensor (about 34 GB per block at
iPRG2012 scale), so the port sends ``fused`` to the bit-identical
``kernel_vpu`` tile instead. Kernel tiles are fixed constants of the
kernels; per-device tuning comes later.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import packing

MATRIX = "matrix"
FUSED = "fused"


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    kind: str          # MATRIX | FUSED
    fn: Callable
    # Matrix backend whose tile fn serves this FUSED backend's prefix/
    # rescore stages (see hamming_tile_fn); None falls back to "vpu".
    tile_name: str | None = None


_REGISTRY: dict[str, Backend] = {}


def register(name: str, kind: str, fn: Callable, *,
             tile_name: str | None = None) -> Backend:
    if kind not in (MATRIX, FUSED):
        raise ValueError(f"backend kind must be {MATRIX!r} or {FUSED!r}, "
                         f"got {kind!r}")
    be = Backend(name=name, kind=kind, fn=fn, tile_name=tile_name)
    _REGISTRY[name] = be
    return be


def get(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {', '.join(names())}"
        ) from None


def names(kind: str | None = None) -> tuple[str, ...]:
    return tuple(n for n, b in _REGISTRY.items()
                 if kind is None or b.kind == kind)


def _kernel_vpu(q, r, dim):
    from repro_torch.kernels.hamming import ops as hops
    return hops.hamming_matrix(q, r)


def _kernel_mxu(q, r, dim):
    from repro_torch.kernels.hamming_mxu import ops as mops
    return mops.hamming_matrix(q, r, dim)


def _fused_cuda(*args, **kw):
    from repro_torch.kernels.hamming import ops as hops
    return hops.fused_search(*args, **kw)


def _fused_mxu(*args, **kw):
    from repro_torch.kernels.hamming_mxu import ops as mops
    return mops.fused_search(*args, **kw)


def _fused_xla(*args, **kw):
    from repro_torch.kernels.hamming import ref as href
    return href.fused_search(*args, **kw)


register("vpu", MATRIX, lambda q, r, dim: packing.hamming_matrix_packed(q, r))
register("mxu", MATRIX, lambda q, r, dim: packing.hamming_matrix_mxu(q, r, dim))
register("kernel_vpu", MATRIX, _kernel_vpu)
register("kernel_mxu", MATRIX, _kernel_mxu)
register("fused", FUSED, _fused_cuda, tile_name="kernel_vpu")
register("fused_mxu", FUSED, _fused_mxu, tile_name="kernel_mxu")
register("fused_xla", FUSED, _fused_xla)


def hamming_tile_fn(name: str) -> Callable:
    """Plain ``(q_hvs, r_hvs, dim) -> (Qb, Rk) hamming`` tile for ``name``.

    The dimension cascade's prefix scan and survivor rescore need a raw
    Hamming tile at any word width. A matrix backend is one; a fused
    backend routes to its ``tile_name`` sibling (``fused`` -> ``kernel_vpu``,
    ``fused_mxu`` -> ``kernel_mxu``) or else (``fused_xla``) to the plain
    packed ``vpu`` tile.
    """
    be = get(name)
    if be.kind == MATRIX:
        return be.fn
    if be.tile_name is not None:
        return get(be.tile_name).fn
    return _REGISTRY["vpu"].fn
