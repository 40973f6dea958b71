"""Contract analysis of the port's hot paths.

Counterpart of ``repro.analysis``: machine-checked contracts (memory,
transfer, dtype, recompile) over the ops a hot function runs — see
:mod:`repro_torch.analysis.registry` for the declaration API,
:mod:`repro_torch.analysis.contracts` for the checkers (and how four of
them are restated for eager PyTorch), :mod:`repro_torch.analysis.op_walk`
for the op recorder and :mod:`repro_torch.analysis.imports` for the
import-graph check.

The contract-matrix runner lives in :mod:`repro_torch.analysis.runner` and is NOT
imported here: the runner imports ``repro_torch.core``, while
``repro_torch.core.backends`` imports :mod:`repro_torch.analysis.registry`
at module level — importing it from the package root would close that
loop. Reach it as ``from repro_torch.analysis import runner`` (or via
``oms.py analyze``).
"""
from repro_torch.analysis import contracts, imports, op_walk, registry
from repro_torch.analysis.contracts import ContractResult, RecompileGuard
from repro_torch.analysis.op_walk import (Op, OpRecorder, find_shape_carriers,
                                          format_op, iter_ops, iter_outputs,
                                          out_bytes, peak_intermediate,
                                          record_ops)
from repro_torch.analysis.registry import (CONTRACT_NAMES, ContractDecl,
                                           contract, declarations, declare,
                                           targets)

__all__ = [
    "contracts", "imports", "op_walk", "registry",
    "ContractResult", "RecompileGuard",
    "Op", "OpRecorder", "find_shape_carriers", "format_op", "iter_ops",
    "iter_outputs", "out_bytes", "peak_intermediate", "record_ops",
    "CONTRACT_NAMES", "ContractDecl", "contract", "declarations", "declare",
    "targets",
]
