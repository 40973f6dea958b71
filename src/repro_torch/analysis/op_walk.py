"""The ONE op walker of the port — every structural memory, dtype and
transfer question of the contract analyzer goes through here.

Counterpart of ``repro.analysis.jaxpr_walk``. Eager PyTorch has no jaxpr to
trace, so :func:`record_ops` runs the hot function once on real tensors
under a ``TorchDispatchMode`` that records every aten op it reaches: its
name, each output's shape, dtype and device, the devices of its tensor
inputs, and the user source line that issued it.

  * A kernel wrapper call (``repro_torch.kernels._build.kernel_op``) is ONE
    op named ``kernel:<name>`` whose outputs are the wrapper's outputs, as
    ``jaxpr_walk`` does not enter ``pallas_call`` bodies: on the card the
    launch is a ctypes call the dispatcher never sees, and on the CPU the
    plain version's (16, rk, W) tile stays inside the op.
  * ``Tensor.tolist`` is recorded as the op ``host:tolist``: on the CPU it
    reads tensor memory without any dispatch, and on the card it is a
    device-to-host copy and a synchronisation.

  * :func:`iter_ops` — every recorded op, in order;
  * :func:`iter_outputs` — (shape, dtype, op) of every recorded output;
  * :func:`peak_intermediate` — the largest recorded output;
  * :func:`find_shape_carriers` — ops whose output carries ALL of a set of
    dimension sizes (a (Qb, Rk[, W]) score/xor matrix);
  * :func:`format_op` — a one-line rendering for contract reports.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _build

_TORCH_DIR = os.path.dirname(torch.__file__)
# Frames of these files are plumbing, never the "user" line of an op.
_SKIP_FILES = {os.path.abspath(__file__), os.path.abspath(_build.__file__)}


@dataclasses.dataclass(frozen=True)
class Op:
    name: str                 # "aten.add.Tensor", "kernel:fused_search", ...
    outputs: tuple            # ((shape, dtype, device type), ...)
    in_devices: tuple         # device types of the tensor inputs
    bool_index: bool          # an index op given a bool mask (a nonzero)
    source: str               # "file:line" of the issuing user code


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _user_line() -> str:
    f = sys._getframe(2)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if not (fn.startswith(_TORCH_DIR) or fn in _SKIP_FILES):
            return f"{os.path.basename(fn)}:{f.f_lineno}"
        f = f.f_back
    return "?"


_MOVING_OPS = ("aten.index_put", "aten._index_put", "aten.copy_", "aten._to_copy")


def _make_op(name: str, args, outs) -> Op:
    outputs = tuple((tuple(t.shape), t.dtype, t.device.type)
                    for t in _tensors(outs))
    # A 0-d CPU tensor is a scalar operand of an elementwise op, but the
    # value an index_put or a copy writes is moved to the device.
    moves = name.startswith(_MOVING_OPS)
    ins = tuple(sorted({t.device.type for t in _tensors(args)
                        if moves or t.dim() or t.device.type != "cpu"}))
    bool_index = (name.startswith(("aten.index.", "aten.index_put", "aten._index_put"))
                  and any(t.dtype == torch.bool for t in _tensors(args[1:])))
    return Op(name, outputs, ins, bool_index, _user_line())


class OpRecorder(TorchDispatchMode):
    """Records the ops of the code run inside ``with OpRecorder() as rec``
    into ``rec.ops``. At most one recorder is active at a time."""

    def __init__(self):
        super().__init__()
        self.ops: list[Op] = []
        self._depth = 0           # > 0 inside a kernel wrapper
        self._tolist = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._depth == 0:
            self.ops.append(_make_op(str(func), args, out))
        return out

    def kernel_call(self, name, fn, args, kwargs):
        self._depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._depth -= 1
        if self._depth == 0:
            self.ops.append(_make_op(f"kernel:{name}", args, out))
        return out

    def __enter__(self):
        if _build.region_hook is not None:
            raise RuntimeError("an op recorder is already active")
        rec = self
        tolist = torch.Tensor.tolist

        def recorded_tolist(t):
            if rec._depth == 0:
                rec.ops.append(Op("host:tolist", (), (t.device.type,), False,
                                  _user_line()))
            return tolist(t)

        self._tolist = tolist
        torch.Tensor.tolist = recorded_tolist
        _build.region_hook = self
        return super().__enter__()

    def __exit__(self, *exc):
        _build.region_hook = None
        torch.Tensor.tolist = self._tolist
        return super().__exit__(*exc)


def record_ops(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpRecorder`;
    returns ``(result, ops)``."""
    with OpRecorder() as rec:
        out = fn(*args, **kwargs)
    return out, rec.ops


def iter_ops(ops) -> Iterator[Op]:
    yield from ops


def iter_outputs(ops) -> Iterator[tuple[tuple, torch.dtype, Op]]:
    """(shape, dtype, op) of every recorded output."""
    for op in ops:
        for shape, dtype, _ in op.outputs:
            yield shape, dtype, op


def out_bytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def peak_intermediate(ops) -> tuple[int, Op | None]:
    """(bytes, op) of the largest recorded output (op None when empty)."""
    best, best_op = 0, None
    for s, d, op in iter_outputs(ops):
        b = out_bytes(s, d)
        if b > best:
            best, best_op = b, op
    return best, best_op


def find_shape_carriers(ops, dims: tuple[int, ...], *,
                        min_rank: int = 2) -> list[Op]:
    """Ops whose output shape carries EVERY size in ``dims`` — an
    intermediate shaped (Qb, Rk[, W]) carries both the q-block and the
    scanned-rows extent. The (Rk, W) reference slice alone does not."""
    hits = []
    for s, _, op in iter_outputs(ops):
        if len(s) >= min_rank and all(d in s for d in dims):
            hits.append(op)
    return hits


def format_op(op: Op, limit: int = 200) -> str:
    """One readable line: op name, outputs, source line."""
    outs = ", ".join(f"{str(d).replace('torch.', '')}{list(s)}@{dev}"
                     for s, d, dev in op.outputs)
    text = f"{op.name} -> {outs or '(host)'} @ {op.source}"
    return text if len(text) <= limit else text[:limit - 3] + "..."
