"""Wrapper of the CUDA hdencode kernel (csrc/hdencode.cu).

On CPU tensors it runs the plain version (:mod:`.ref`); on CUDA tensors it
launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hdencode import ref

launches = _build.LaunchCounter()


@_build.kernel_op("hdencode")
def hdencode(bins: torch.Tensor, levels: torch.Tensor, mask: torch.Tensor,
             id_hvs: torch.Tensor, level_hvs: torch.Tensor,
             tiebreak: torch.Tensor) -> torch.Tensor:
    """bins/levels (B, P) int32, mask (B, P) bool, id_hvs (F, W),
    level_hvs (L, W), tiebreak (W,) int32 -> packed HVs (B, W) int32."""
    if bins.device.type == "cpu":
        return ref.hdencode(bins, levels, mask, id_hvs, level_hvs, tiebreak)
    dev = bins.device
    if dev.type != "cuda":
        raise ValueError(f"hdencode: unsupported device {dev}")
    for name, t, dtype, ndim in (("bins", bins, torch.int32, 2),
                                 ("levels", levels, torch.int32, 2),
                                 ("mask", mask, torch.bool, 2),
                                 ("id_hvs", id_hvs, torch.int32, 2),
                                 ("level_hvs", level_hvs, torch.int32, 2),
                                 ("tiebreak", tiebreak, torch.int32, 1)):
        _build.check_tensor("hdencode", name, t, dtype, ndim, dev)
    B, P = bins.shape
    W = id_hvs.shape[1]
    if levels.shape != (B, P) or mask.shape != (B, P):
        raise ValueError("hdencode: bins, levels and mask must share one (B, P) shape")
    if level_hvs.shape[1] != W or tiebreak.shape[0] != W:
        raise ValueError("hdencode: codebooks must share one word count W")
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib = _build.library()
    with _build.on_device(dev):
        rc = lib.hdencode_launch(
            _build.ptr(bins), _build.ptr(levels), _build.ptr(mask),
            _build.ptr(id_hvs), _build.ptr(level_hvs), _build.ptr(tiebreak),
            _build.ptr(out), ctypes.c_int(B), ctypes.c_int(P), ctypes.c_int(W),
            _build.stream_ptr(dev))
    _build.check(rc, "hdencode_launch")
    launches.count += 1
    return out
