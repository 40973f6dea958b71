"""A named grid of devices: the part of ``jax.sharding.Mesh`` (and of
``jax.make_mesh``) that the sharded OMS search reads.

One process drives every device of a mesh: a sharded search enqueues each
shard's work on that shard's device and gathers the winners to one of
them, so there is no process group and no launcher per device. A mesh may
repeat a device (``["cpu"] * 8``, or ``[cuda:0] * 4`` on a one-card
machine): that is for checks, and the shards on one device then run one
after another.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device


class Mesh:
    """``devices``: an array of ``torch.device`` with one dimension per
    name in ``axis_names``. ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.array(devices, dtype=object)
        names = tuple(axis_names)
        if devs.ndim != len(names):
            raise ValueError(f"a mesh of {devs.ndim} dimensions needs as many "
                             f"axis names, got {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names must differ, got {names}")
        flat = devs.reshape(-1)
        for i, d in enumerate(flat):
            flat[i] = torch.device(d)
        self.devices = flat.reshape(devs.shape)
        self.axis_names = names
        self.shape = dict(zip(names, devs.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}: {self.axis_names}")
        devs = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(devs.reshape(self.shape[axis], -1)[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.reshape(-1).tolist()})"


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              devices: Sequence | None = None) -> Mesh:
    """Lay ``devices`` out row-major as a mesh of ``axis_shapes``.
    ``devices=None`` takes every CUDA device (and raises without one); the
    product of the shape must equal the number of devices."""
    if devices is None:
        resolve_device(None)        # raises without a GPU
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    want = math.prod(axis_shapes)
    if want != len(devices):
        raise ValueError(f"a mesh of shape {tuple(axis_shapes)} needs {want} "
                         f"devices, got {len(devices)} (a list may repeat a "
                         f"device)")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(axis_shapes)), axis_names)
