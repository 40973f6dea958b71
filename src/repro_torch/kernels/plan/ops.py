"""Wrapper of the CUDA planner's reach kernel (csrc/plan_reach.cu).

On CPU tensors it runs the plain version (:mod:`.ref`); on CUDA tensors it
launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.plan import ref

launches = _build.LaunchCounter()


@_build.kernel_op("plan_reach")
def plan_reach(qp: torch.Tensor, qc: torch.Tensor, kmin: torch.Tensor,
               kmax: torch.Tensor, *, q_block: int,
               open_tol_da: float) -> torch.Tensor:
    """qp (Q,) float32 and qc (Q,) int32 sorted by (charge, pmz), kmin /
    kmax (n_blocks,) int64 sorted pair keys (:func:`.ref.pair_key`) -> a
    one-element tensor: the most blocks a q-block segment reaches, 0 where
    none does (:func:`.ref.plan_reach`)."""
    if qp.device.type == "cpu":
        return ref.plan_reach(qp, qc, kmin, kmax, q_block=q_block,
                              open_tol_da=open_tol_da)
    dev = qp.device
    if dev.type != "cuda":
        raise ValueError(f"plan_reach: unsupported device {dev}")
    for name, t, dtype in (("qp", qp, torch.float32), ("qc", qc, torch.int32),
                           ("kmin", kmin, torch.int64), ("kmax", kmax, torch.int64)):
        _build.check_tensor("plan_reach", name, t, dtype, 1, dev)
    Q, n_blocks = qp.shape[0], kmin.shape[0]
    if qc.shape[0] != Q or kmax.shape[0] != n_blocks:
        raise ValueError("plan_reach: qp / qc and kmin / kmax must pair in length")
    if q_block < 1:
        raise ValueError(f"plan_reach: q_block must be >= 1, got {q_block}")
    out = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = _build.library()
    with _build.on_device(dev):
        rc = lib.plan_reach_launch(
            _build.ptr(qp), _build.ptr(qc), _build.ptr(kmin), _build.ptr(kmax),
            _build.ptr(out), ctypes.c_int(Q), ctypes.c_int(n_blocks),
            ctypes.c_int(q_block), ctypes.c_float(open_tol_da),
            _build.stream_ptr(dev))
    _build.check(rc, "plan_reach_launch")
    launches.count += 1
    return out
