"""The contract checkers — named, machine-checked invariants over the ops
a hot function ran.

Counterpart of ``repro.analysis.contracts``. Each checker takes the ops
:func:`repro_torch.analysis.op_walk.record_ops` recorded (plus
contract-specific context) and returns a :class:`ContractResult`; on
failure the result names the *offending op* (rendered through
:func:`~repro_torch.analysis.op_walk.format_op`) in its ``eqn`` field, the
reference's report key.

Eager PyTorch differs from a traced jaxpr, so four contracts are restated:

  * ``peak_intermediate`` — the largest recorded output is at most the
    declared bound; on CUDA the rise of ``torch.cuda.max_memory_allocated``
    over the call is reported beside it (``allocator_bytes``).
  * ``no_host_transfer`` — no op that synchronises the host with the
    device: ``aten._local_scalar_dense`` (``.item()``, ``bool(t)``),
    ``nonzero`` and the other ops whose output size depends on the data,
    an index op given a bool mask, ``Tensor.tolist``, and no copy between
    host and device. On CUDA the call also runs under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any
    synchronisation the recorder cannot see.
  * ``dtype_stability`` — eager PyTorch indexes with int64 (``argsort``,
    ``arange``, gathers) and the fused wrappers' composite keys are int64
    by design, so "no 64-bit intermediate anywhere" cannot hold. Restated:
    no float64 anywhere; no 64-bit tensor whose last dimension is the word
    count W, or that carries the (Qb, Rk) pair; every >= 2-D integer
    (..., W) packed-HV carrier is int32.
  * ``recompile_guard`` — eager PyTorch has no jit cache. Restated:
    repeated same-shape calls cause no kernel build (the build counter of
    ``repro_torch.kernels._build``), and on CUDA no growth of
    ``torch.cuda.memory_reserved()`` after the first call.

``no_materialize`` is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.analysis.op_walk import (find_shape_carriers, format_op,
                                          iter_ops, iter_outputs,
                                          peak_intermediate)
from repro_torch.kernels import _build


@dataclasses.dataclass(frozen=True)
class ContractResult:
    contract: str
    target: str
    passed: bool
    detail: str = ""
    eqn: str | None = None      # offending op (failures only)
    allocator_bytes: int | None = None   # CUDA allocator rise (peak only)

    def as_dict(self) -> dict:
        d = {"contract": self.contract, "target": self.target,
             "passed": self.passed, "detail": self.detail}
        if self.eqn is not None:
            d["eqn"] = self.eqn
        if self.allocator_bytes is not None:
            d["allocator_bytes"] = self.allocator_bytes
        return d


# ---------------------------------------------------------------------------
# 1. no_materialize — the (Qb, Rk) score matrix never lands in memory
# ---------------------------------------------------------------------------


def check_no_materialize(ops, *, q_block: int, r_rows: int,
                         target: str = "") -> ContractResult:
    """No recorded output outside a kernel wrapper carries BOTH the q-block
    and the scanned-rows dimension — a (Qb, Rk[, W])-shaped score/xor
    matrix. The (Rk, W) reference slice itself does not count."""
    hits = find_shape_carriers(ops, (q_block, r_rows))
    if hits:
        return ContractResult(
            "no_materialize", target, False,
            f"{len(hits)} intermediate(s) carry both Qb={q_block} and "
            f"Rk={r_rows} — a materialised score matrix",
            eqn=format_op(hits[0]))
    return ContractResult("no_materialize", target, True,
                          f"no (Qb={q_block}, Rk={r_rows}) intermediate")


# ---------------------------------------------------------------------------
# 2. peak_intermediate <= bound
# ---------------------------------------------------------------------------


def check_peak_intermediate(ops, *, bound_bytes: int, target: str = "",
                            allocator_bytes: int | None = None
                            ) -> ContractResult:
    peak, op = peak_intermediate(ops)
    detail = f"peak {peak} B vs bound {bound_bytes} B"
    if allocator_bytes is not None:
        detail += f"; allocator rise {allocator_bytes} B"
    if peak > bound_bytes:
        return ContractResult("peak_intermediate", target, False, detail,
                              eqn=format_op(op) if op is not None else None,
                              allocator_bytes=allocator_bytes)
    return ContractResult("peak_intermediate", target, True, detail,
                          allocator_bytes=allocator_bytes)


# ---------------------------------------------------------------------------
# 3. no_host_transfer — nothing waits for the device inside the hot path
# ---------------------------------------------------------------------------

# Ops that hand a device value to the host (and so wait for the device):
# a scalar read, and the ops whose output size depends on the data.
SYNC_OPS = frozenset({
    "aten._local_scalar_dense.default", "aten.item.default",
    "aten.is_nonzero.default", "aten.equal.default",
    "aten.nonzero.default", "aten.nonzero_numpy.default",
    "aten.masked_select.default", "aten.repeat_interleave.Tensor",
    "aten._unique.default", "aten._unique2.default",
    "aten.unique_dim.default", "aten.unique_consecutive.default",
    "aten.unique_dim_consecutive.default", "host:tolist",
})


def _syncs(op) -> str | None:
    """Why ``op`` moves data between host and device, or None."""
    if op.name in SYNC_OPS:
        return f"{op.name!r} reads a device value on the host"
    if op.bool_index:
        return f"{op.name!r} with a bool mask (a nonzero on the host)"
    outs = {dev for _, _, dev in op.outputs}
    if op.in_devices and outs and (set(op.in_devices) | outs) >= {"cpu", "cuda"}:
        return f"{op.name!r} copies between host and device"
    return None


def check_no_host_transfer(ops, *, target: str = "",
                           sync_error: str | None = None) -> ContractResult:
    for op in iter_ops(ops):
        why = _syncs(op)
        if why:
            return ContractResult("no_host_transfer", target, False,
                                  f"{why} inside the hot path",
                                  eqn=format_op(op))
    if sync_error is not None:
        return ContractResult(
            "no_host_transfer", target, False,
            "the call synchronised under torch.cuda.set_sync_debug_mode"
            f"('error'): {sync_error.splitlines()[0][:160]}")
    return ContractResult("no_host_transfer", target, True,
                          "no scalar read, data-dependent size, tolist or "
                          "host<->device copy")


# ---------------------------------------------------------------------------
# 4. dtype_stability — no float64; 64-bit never on W-carriers or (Qb, Rk)
# ---------------------------------------------------------------------------


def check_dtype_stability(ops, *, target: str = "",
                          hv_words: int | None = None,
                          q_block: int | None = None,
                          r_rows: int | None = None) -> ContractResult:
    """Three clauses (the eager restatement of "no 64-bit intermediate"):

    * no recorded output is float64 (or complex128);
    * no 64-bit output has the word count W as its last dimension, or
      carries both Qb and Rk;
    * with ``hv_words`` given, every >= 2-D integer output whose last
      dimension is W is int32 — packed HVs never change carrier dtype on
      their way to the XOR/popcount.
    """
    for shape, dtype, op in iter_outputs(ops):
        if dtype in (torch.float64, torch.complex128):
            return ContractResult(
                "dtype_stability", target, False,
                f"{dtype} intermediate {list(shape)} in the hot path",
                eqn=format_op(op))
        w_carrier = (hv_words is not None and len(shape) >= 2
                     and shape[-1] == hv_words)
        pair = (q_block is not None and r_rows is not None and len(shape) >= 2
                and q_block in shape and r_rows in shape)
        if dtype.itemsize >= 8 and (w_carrier or pair):
            return ContractResult(
                "dtype_stability", target, False,
                f"64-bit {dtype} intermediate {list(shape)} on an HV word "
                f"or (Qb, Rk) carrier", eqn=format_op(op))
        if (w_carrier and dtype not in (torch.int32, torch.bool)
                and not dtype.is_floating_point):
            return ContractResult(
                "dtype_stability", target, False,
                f"packed-HV-shaped intermediate [..., {hv_words}] changed "
                f"carrier dtype to {dtype}", eqn=format_op(op))
    return ContractResult(
        "dtype_stability", target, True,
        "no float64; no 64-bit W or (Qb, Rk) carrier"
        + ("" if hv_words is None else f"; [..., {hv_words}] words stay int32"))


# ---------------------------------------------------------------------------
# 5. recompile_guard — no kernel build, no allocator growth on repeats
# ---------------------------------------------------------------------------


def _reserved() -> int:
    return torch.cuda.memory_reserved() if torch.cuda.is_initialized() else 0


class RecompileGuard:
    """Tracks kernel builds (and on CUDA the caching allocator's reserved
    bytes) across calls.

    Usage: run the warm-up call(s), ``arm()``, run the steady-state
    call(s), then ``check()`` — a build after arming means a same-shape
    call compiled a kernel again, and reserved growth means every repeat
    asks the allocator for new memory. ``reserved`` (default: the CUDA
    allocator's reserved bytes, 0 on the CPU) is injectable for tests.
    """

    def __init__(self, tracked=(), *, reserved: Callable[[], int] | None = None):
        self.tracked = list(tracked)
        self._reserved = reserved or _reserved
        self._armed: tuple[int, int] | None = None

    def arm(self) -> None:
        self._armed = (_build.builds, self._reserved())

    def churn(self) -> dict[str, int]:
        if self._armed is None:
            raise RuntimeError("RecompileGuard.churn() before arm()")
        out = {}
        builds = _build.builds - self._armed[0]
        grew = self._reserved() - self._armed[1]
        if builds > 0:
            out["kernel builds"] = builds
        if grew > 0:
            out["reserved bytes"] = grew
        return out

    def check(self, *, target: str = "") -> ContractResult:
        churn = self.churn()
        if churn:
            worst = max(churn, key=churn.get)
            return ContractResult(
                "recompile_guard", target, False,
                "repeated same-shape calls grew: "
                + ", ".join(f"{k}(+{v})" for k, v in churn.items()),
                eqn=f"grew: {worst}")
        tracked = ", ".join(self.tracked) or "kernel library"
        return ContractResult("recompile_guard", target, True,
                              f"no kernel build or allocator growth across "
                              f"repeat calls ({tracked})")


# ---------------------------------------------------------------------------
# Dispatch: evaluate one declaration against recorded ops + context
# ---------------------------------------------------------------------------


def evaluate(decl, ops, ctx: dict[str, Any], *,
             sync_error: str | None = None,
             allocator_bytes: int | None = None) -> ContractResult:
    """Run the checker a :class:`~repro_torch.analysis.registry.ContractDecl`
    names. ``ctx`` carries the smoke-shape facts (q_block, rk, n_words,
    ...); ``recompile_guard`` is runtime-only and handled by the runner.
    A checker that raises is a failed check."""
    try:
        if decl.contract == "no_materialize":
            res = check_no_materialize(ops, q_block=ctx["q_block"],
                                       r_rows=ctx["rk"], target=decl.target)
        elif decl.contract == "peak_intermediate":
            res = check_peak_intermediate(
                ops, bound_bytes=int(decl.bound(ctx)), target=decl.target,
                allocator_bytes=allocator_bytes)
        elif decl.contract == "no_host_transfer":
            res = check_no_host_transfer(ops, target=decl.target,
                                         sync_error=sync_error)
        elif decl.contract == "dtype_stability":
            res = check_dtype_stability(ops, target=decl.target,
                                        hv_words=ctx.get("n_words"),
                                        q_block=ctx.get("q_block"),
                                        r_rows=ctx.get("rk"))
        else:
            raise ValueError(f"evaluate() cannot run {decl.contract!r}")
    except Exception as e:          # a checker that raises fails its check
        res = ContractResult(decl.contract, decl.target, False,
                             f"checker raised {type(e).__name__}: {e}")
    return _apply_expectation(decl, res)


def _apply_expectation(decl, res: ContractResult) -> ContractResult:
    """Fold a declaration's ``expect`` flag into the result: an expected
    violation (documented exemption) passes with a note; an exemption that
    unexpectedly PASSES is flagged for cleanup."""
    if decl.expect:
        return res
    if res.passed:
        return dataclasses.replace(
            res, passed=False,
            detail=res.detail + " — declared exempt but now passes; "
                                "remove the stale exemption")
    return dataclasses.replace(
        res, passed=True,
        detail=res.detail + f" — documented exemption ({decl.note})",
        eqn=res.eqn)
