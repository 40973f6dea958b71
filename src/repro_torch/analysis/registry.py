"""Contract registry — declarations live NEXT TO the code they protect.

Counterpart of ``repro.analysis.registry`` (the same names, contracts and
declaration API). A *contract* is a named, machine-checked invariant over
the ops a hot function runs (see :mod:`repro_torch.analysis.contracts` for
the checkers and :mod:`repro_torch.analysis.runner` for the runner that
records every registered encode x search backend combination).
Declarations are made where the protected code is registered —
``repro_torch.core.backends`` / ``repro_torch.core.encode_backends``
declare per-backend contracts alongside their ``register(...)`` calls,
``repro_torch.serve.engine`` declares the slab step's — so a new backend
cannot be added without stating its memory story.

Targets are ``"<domain>:<name>"`` strings:

  * ``search:<backend>``  — one blocked-scan step of a search backend;
  * ``prefix:<backend>`` / ``rescore:<backend>`` — the dimension cascade's
                            stage-A scan and stage-B rescore;
  * ``encode:<backend>``  — the preprocess+encode hot path of an encoder;
  * ``serve:slab_step``   — one streamed slab scan of the serve engine;
  * ``serve:loop``        — the repeated-call behaviour of the serve loop
                            (recompile_guard runs calls, not recordings).

Contract names (the six invariants; four are restated for eager PyTorch
in :mod:`repro_torch.analysis.contracts`):

  * ``no_materialize``    — no intermediate carries the full
                            (q-block x scanned-rows) score matrix;
  * ``peak_intermediate`` — largest intermediate <= the declared ``bound``
                            (a callable over the context);
  * ``no_host_transfer``  — nothing in the hot path waits for the device
                            or copies between host and device;
  * ``dtype_stability``   — no float64, no 64-bit HV-word or (Qb, Rk)
                            carrier; packed HVs stay int32;
  * ``recompile_guard``   — repeated same-shape calls build no kernel and
                            grow no allocator reservation;
  * ``trace_transparency``— installing a ``repro_torch.obs`` tracer
                            changes neither the recorded hot op sequence
                            nor a single result byte.

This module is DEPENDENCY-FREE on purpose (stdlib only): it is imported at
module level by ``repro_torch.core.backends``/``encode_backends``, so
importing anything from ``repro_torch.core`` here would create an import
cycle — the failure mode ``repro_torch.analysis.imports`` (the ``analyze
--imports`` check) guards against.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

CONTRACT_NAMES = ("no_materialize", "peak_intermediate", "no_host_transfer",
                  "dtype_stability", "recompile_guard", "trace_transparency")


@dataclasses.dataclass(frozen=True)
class ContractDecl:
    """One declared invariant on one target.

    ``bound`` (peak_intermediate only) maps a context — a mapping
    with the smoke-shape facts (``q_block``, ``rk``, ``dim``, ``n_words``,
    ``batch``, ``peaks``, ``top_k``, ...) — to a byte budget.
    ``expect=False`` records a DOCUMENTED exemption (e.g. ``fused_xla``
    materialises the tile internally by design — it is the validation
    backend): the analyzer still measures and reports it, but an observed
    violation is "expected" and does not fail the run, while an
    *unexpected pass* is flagged so stale exemptions get cleaned up.
    """

    target: str                 # "search:fused", "encode:word_tiled", ...
    contract: str               # one of CONTRACT_NAMES
    bound: Callable[[Mapping[str, Any]], int] | None = None
    note: str = ""
    expect: bool = True


_DECLS: list[ContractDecl] = []


def declare(target: str, contract: str, *, bound=None, note: str = "",
            expect: bool = True) -> ContractDecl:
    if contract not in CONTRACT_NAMES:
        raise ValueError(f"unknown contract {contract!r}; "
                         f"valid: {', '.join(CONTRACT_NAMES)}")
    if contract == "peak_intermediate" and bound is None:
        raise ValueError("peak_intermediate declarations need a bound=ctx->bytes")
    decl = ContractDecl(target=target, contract=contract, bound=bound,
                        note=note, expect=expect)
    _DECLS.append(decl)
    return decl


def contract(target: str, *contracts: str, bound=None, note: str = "",
             expect: bool = True):
    """Decorator form of :func:`declare` — stamp contracts on a function
    (a serve step, a backend fn) where a decorator reads better than a
    trailing declare() call. Returns the function unchanged."""
    def deco(fn):
        for c in contracts:
            declare(target, c, bound=bound, note=note, expect=expect)
        return fn
    return deco


def declarations(target: str | None = None,
                 contract: str | None = None) -> tuple[ContractDecl, ...]:
    return tuple(d for d in _DECLS
                 if (target is None or d.target == target)
                 and (contract is None or d.contract == contract))


def targets(domain: str | None = None) -> tuple[str, ...]:
    seen: dict[str, None] = {}
    for d in _DECLS:
        if domain is None or d.target.startswith(domain + ":"):
            seen.setdefault(d.target)
    return tuple(seen)
