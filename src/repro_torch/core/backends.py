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
``kernel_vpu`` tile instead.

The CUDA backends resolve their launch parameters through
``repro_torch.tune.tiles_for`` at dispatch (the wrappers' defaults,
overlaid with promoted per-device constants, overlaid with any on-disk
sweep-winner cache): the fused kernels' ``waves`` / ``min_split_rows``
(their split count) and the tile kernels' ``ctas_per_sm`` (their grid).
The ``peak_intermediate`` contract bounds below are stated through the
same resolver, so a tuned value moves the declared bound with the launch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

# Dependency-free registry (stdlib only) — safe at module level, checked by
# `oms.py analyze --imports`.
from repro_torch.analysis.registry import declare as _declare
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


def _tuned(backend: str, dim: int, k: int, q_rows: int, r_rows: int,
           device) -> dict:
    """Effective launch parameters of one hot call (lazy tune import; pure
    for a fixed loaded winner cache)."""
    from repro_torch import tune
    return tune.tiles_for(backend, dim=dim, k=k, q_rows=q_rows,
                          r_rows=r_rows, device=device)


def _kernel_vpu(q, r, dim):
    from repro_torch.kernels.hamming import ops as hops
    t = _tuned("kernel_vpu", dim, 0, q.shape[0], r.shape[0], q.device)
    return hops.hamming_matrix(q, r, ctas_per_sm=t["ctas_per_sm"])


def _kernel_mxu(q, r, dim):
    from repro_torch.kernels.hamming_mxu import ops as mops
    t = _tuned("kernel_mxu", dim, 0, q.shape[0], r.shape[0], q.device)
    return mops.hamming_matrix(q, r, dim, ctas_per_sm=t["ctas_per_sm"])


def _fused_split(backend: str, q_hvs, kw) -> dict:
    """The split-count parameters of one fused call: keyed like the
    reference's per-block call, by (q_block, rk)."""
    t = _tuned(backend, kw["dim"], kw["k"], kw["q_block"], kw["rk"],
               q_hvs.device)
    return {"waves": t["waves"], "min_split_rows": t["min_split_rows"]}


def _fused_cuda(*args, **kw):
    from repro_torch.kernels.hamming import ops as hops
    return hops.fused_search(*args, **kw, **_fused_split("fused", args[0], kw))


def _fused_mxu(*args, **kw):
    from repro_torch.kernels.hamming_mxu import ops as mops
    return mops.fused_search(*args, **kw, **_fused_split("fused_mxu", args[0], kw))


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


# ---------------------------------------------------------------------------
# Contracts — the memory/transfer/dtype story of each backend, declared next
# to its registration and machine-checked by `oms.py analyze` (the runner
# records one blocked-scan step per backend and evaluates these; see
# repro_torch.analysis). The (target, contract) pairs are the reference's;
# the bounds are the port's own allocations.
# ---------------------------------------------------------------------------

def _declare_common(target: str) -> None:
    _declare(target, "no_host_transfer")
    _declare(target, "dtype_stability")


for _t in ("search:vpu", "search:mxu", "search:kernel_vpu",
           "search:kernel_mxu", "search:fused", "search:fused_mxu",
           "search:fused_xla"):
    _declare_common(_t)

# Largest single output of ONE blocked-scan step, as a function of the
# context (q_block, rk = scanned rows, n_words, dim, top_k, n_queries =
# sorted/padded queries, n_rows = DB rows, n_sms, device). Matrix backends
# gather each block's rows by a device index — an (rk, W) int32 copy — and
# reduce a (Qb, rk) int32 tile; the fused wrappers read the DB in place
# and allocate the split kernel's partial buffer, whose size follows the
# split count — resolved through the SAME ``repro_torch.tune.tiles_for``
# the dispatch fns above use, so a tuned waves / min_split_rows moves the
# declared bound with the launch.


def _sidecars(c) -> int:
    """(n_rows,) 4-byte sidecars and the (rk,) int64 gather index."""
    return max(c.get("n_rows", 0) * 4, c["rk"] * 8)


def _tile_bound(c) -> int:
    """A CUDA tile kernel (or its plain version): the (Qb, rk) int32 tile
    and the masks and selections over it, the (rk, W) gathered rows."""
    return max(c["q_block"] * c["rk"] * 4, c["rk"] * c["n_words"] * 4,
               _sidecars(c))


def _vpu_bound(c) -> int:
    """The packed XOR / popcount tensor (Qb, rk, W) int32."""
    return max(c["q_block"] * c["rk"] * c["n_words"] * 4, _sidecars(c))


def _mxu_bound(c) -> int:
    """The +-1 unpack of the rows, (rk, W, 32) int32."""
    return max(c["rk"] * 32 * c["n_words"] * 4, c["q_block"] * c["rk"] * 4,
               _sidecars(c))


def _fused_bound_for(backend: str):
    def bound(c):
        from repro_torch.kernels.hamming import ops as hops
        from repro_torch.kernels.hamming_mxu import ops as mops
        t = _tuned(backend, c["dim"], c["top_k"], c["q_block"], c["rk"],
                   c.get("device"))
        scratch = mops.FUSED_SCRATCH_PER_TILE if backend == "fused_mxu" else 0
        partial = hops.fused_partial_bytes(
            c["n_queries"], c["q_block"], c["rk"], c["top_k"], c["n_sms"],
            n_words=c["n_words"], scratch_per_tile=scratch,
            waves=t["waves"], min_split_rows=t["min_split_rows"])
        # the partial buffer, the (Qp, k) winners, a (Qp,) 8-byte plan
        # array, the (n_rows,) sidecars
        return max(partial, c["n_queries"] * c["top_k"] * 4,
                   c["n_queries"] * 8, c.get("n_rows", 0) * 4)
    return bound


_declare("search:vpu", "peak_intermediate", bound=_vpu_bound,
         note="packed XOR/popcount tensor (Qb, Rk, W)")
_declare("search:mxu", "peak_intermediate", bound=_mxu_bound,
         note="+-1 unpack (Rk, W, 32) int32 of the gathered rows")
_declare("search:kernel_vpu", "peak_intermediate", bound=_tile_bound,
         note="CUDA tile kernel: (Qb, Rk) int32 tile / (Rk, W) gathered rows")
_declare("search:kernel_mxu", "peak_intermediate", bound=_tile_bound,
         note="CUDA int8 tile kernel: (Qb, Rk) int32 tile / (Rk, W) "
              "gathered rows")
_declare("search:fused", "peak_intermediate",
         bound=_fused_bound_for("fused"),
         note="fused CUDA kernel: the winner lists' partial buffer "
              "(n_tiles, n_splits, 32, k) int64 (n_splits = 1 with lists in "
              "device memory) or the (Qp, k) winners; the DB is read in place")
_declare("search:fused_mxu", "peak_intermediate",
         bound=_fused_bound_for("fused_mxu"),
         note="fused int8 CUDA kernel: the split partial buffer or the "
              "(Qp, k) winners; the +-1 operands live in shared memory")
_declare("search:fused_xla", "peak_intermediate", bound=_vpu_bound,
         note="plain fused version materialises the xor tensor like vpu")

# Dimension-cascade stages. ``prefix:<be>`` is one stage-A survivor-flag
# scan (ctx n_words = prefix_words, n_rows DB rows: the (n_rows,) keep
# counts are the extra non-tile intermediate); ``rescore:<be>`` is one
# stage-B exact rescore over an rk = survivor-bucket candidate set at full
# width. Fused backends route both stages through their tile sibling (see
# ``hamming_tile_fn``): fused runs them on the kernel_vpu tile, fused_mxu
# on the kernel_mxu tile, fused_xla on the packed-VPU tile — each declared
# bound is its tile fn's bound.

for _t, _b, _n in (
    ("prefix:vpu", _vpu_bound, "packed XOR tensor (Qb, Rk, P)"),
    ("prefix:mxu", _mxu_bound, "+-1 unpack (Rk, P, 32) int32"),
    ("prefix:kernel_vpu", _tile_bound,
     "CUDA tile output (Qb, Rk) / gathered (Rk, P) rows"),
    ("prefix:kernel_mxu", _tile_bound,
     "CUDA int8 tile output (Qb, Rk) / gathered (Rk, P) rows"),
    ("prefix:fused", _tile_bound, "kernel_vpu tile sibling"),
    ("prefix:fused_mxu", _tile_bound, "kernel_mxu tile sibling"),
    ("prefix:fused_xla", _vpu_bound, "packed-VPU tile"),
    ("rescore:vpu", _vpu_bound, "packed XOR tensor (Qb, S, W)"),
    ("rescore:mxu", _mxu_bound, "+-1 unpack (S, W, 32) int32"),
    ("rescore:kernel_vpu", _tile_bound, "CUDA tile output (Qb, S)"),
    ("rescore:kernel_mxu", _tile_bound, "CUDA int8 tile output (Qb, S)"),
    ("rescore:fused", _tile_bound, "kernel_vpu tile sibling"),
    ("rescore:fused_mxu", _tile_bound, "kernel_mxu tile sibling"),
    ("rescore:fused_xla", _vpu_bound, "packed-VPU tile"),
):
    _declare_common(_t)
    _declare(_t, "peak_intermediate", bound=_b, note=_n)

# The single-pass kernels never materialise the (Qb, Rk) score matrix;
# matrix-kind backends compute exactly that tile BY DESIGN, so the contract
# is only declared on the fused backends. fused_xla is the documented
# exemption: it is FUSED-kind (consumes windows, returns ranked winners)
# but its plain reduction materialises the tile — it exists for
# validation, and the analyzer reports (rather than fails) it.
_declare("search:fused", "no_materialize",
         note="single-pass running top-k; the tile lives in registers")
_declare("search:fused_mxu", "no_materialize",
         note="single-pass running top-k; the +-1 operands and the MMA "
              "tile live in shared memory and registers")
_declare("search:fused_xla", "no_materialize", expect=False,
         note="the plain reduction materialises the tile by design "
              "(validation backend)")
