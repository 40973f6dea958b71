"""Production mesh construction.

Counterpart of ``repro.launch.mesh``, built on
:class:`repro_torch.distributed.mesh.Mesh`: one process drives every
device of the mesh (no process group). ``devices=None`` takes every CUDA
device of this machine; an explicit list may repeat a device or hold
``meta`` entries (the dry run lays the production meshes out on 256 and
512 of them).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.mesh import Mesh, make_mesh


def _devices(devices) -> list[torch.device]:
    if devices is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 = 256 devices per pod; multi-pod adds a leading pod axis (2
    pods). Raises unless there are exactly that many devices, as
    ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = _devices(devices)
    if len(devs) != math.prod(shape):
        raise ValueError(f"the production mesh {shape} {axes} needs exactly "
                         f"{math.prod(shape)} devices, found {len(devs)}")
    return make_mesh(shape, axes, devices=devs)


def make_local_mesh(model_axis: int = 1, *, devices=None) -> Mesh:
    """Whatever this host has (tests / smoke): (data, model)."""
    devs = _devices(devices)
    if not devs:
        raise ValueError("a local mesh needs a device: this host has no CUDA "
                         "device (pass devices=['cpu'])")
    model_axis = min(model_axis, len(devs))
    return make_mesh((len(devs) // model_axis, model_axis), ("data", "model"),
                     devices=devs)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
