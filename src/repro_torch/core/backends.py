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

Registered so far:

  name        kind    engine
  ----------  ------  -----------------------------------------------------
  vpu         matrix  packed XOR + SWAR popcount (plain torch)
  fused       fused   the hand-written CUDA fused search kernel
                      (kernels/hamming); its plain version on CPU tensors
  fused_xla   fused   the plain version of ``fused``

``mxu``, ``kernel_vpu``, ``kernel_mxu`` and ``fused_mxu`` are not ported
yet, so :func:`get` rejects them and lists what is registered. Kernel tiles
are fixed constants of the kernels; per-device tuning comes later.
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


_REGISTRY: dict[str, Backend] = {}


def register(name: str, kind: str, fn: Callable) -> Backend:
    if kind not in (MATRIX, FUSED):
        raise ValueError(f"backend kind must be {MATRIX!r} or {FUSED!r}, "
                         f"got {kind!r}")
    be = Backend(name=name, kind=kind, fn=fn)
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


def _fused_cuda(*args, **kw):
    from repro_torch.kernels.hamming import ops as hops
    return hops.fused_search(*args, **kw)


def _fused_xla(*args, **kw):
    from repro_torch.kernels.hamming import ref as href
    return href.fused_search(*args, **kw)


register("vpu", MATRIX, lambda q, r, dim: packing.hamming_matrix_packed(q, r))
register("fused", FUSED, _fused_cuda)
register("fused_xla", FUSED, _fused_xla)
