"""Elastic scaling: rebuild a smaller/larger mesh and reshard state.

Counterpart of ``repro.distributed.elastic``. The protocol:
  1. a health check (simulated) reports the surviving device set;
  2. ``remesh()`` builds the largest (data', model) mesh that fits it —
     the model axis is preserved (TP degree is a property of the program),
     the data axis shrinks/grows;
  3. state is resharded onto the new mesh by ``sharding.place`` —
     checkpoint restore (``restore_checkpoint(shardings=...)``) takes the
     same path, so recovery from disk and live reshard share code.

One process drives every device, so a mesh of repeated devices
(``["cpu"] * 8``, ``[cuda:0] * 4``) runs the same code as distinct cards.
"""
from __future__ import annotations

import numpy as np

from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import (NamedSharding, enforce_divisibility, place,
                                              tree_map)


def remesh(devices, model_axis_size: int, *, axis_names=("data", "model")) -> Mesh:
    """Largest (data, model) mesh from the surviving device list."""
    n = len(devices)
    if n < model_axis_size:
        raise ValueError(f"cannot keep TP={model_axis_size} with {n} devices")
    data = n // model_axis_size
    grid = np.empty(data * model_axis_size, dtype=object)
    grid[:] = list(devices[: data * model_axis_size])
    return Mesh(grid.reshape(data, model_axis_size), axis_names)


def reshard_tree(tree, pspecs, new_mesh: Mesh):
    """Reshard a tree (plain tensors or ``Sharded`` leaves) onto a new mesh.

    A shrunken data axis may no longer divide some dims (e.g. 8 rows over a
    3-way survivor axis); those dims fall back to replication via the same
    ``enforce_divisibility`` rule the launchers use — elastic restart never
    fails on arithmetic, it just degrades sharding for the odd leaf."""
    fixed = enforce_divisibility(pspecs, tree, new_mesh)
    return tree_map(lambda _, x, spec: place(x, NamedSharding(new_mesh, spec)),
                    tree, fixed)


def simulate_node_failure(mesh: Mesh, n_lost_nodes: int, devices_per_node=1) -> list:
    """Drop the last n nodes' devices; return the survivor list."""
    devs = list(mesh.devices.flat)
    return devs[: len(devs) - n_lost_nodes * devices_per_node]
