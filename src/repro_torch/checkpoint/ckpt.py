"""Step-atomic checkpointing with manifest + checksums (+async).

Counterpart of ``repro.checkpoint.ckpt``, in its on-disk format byte for
byte, so either package restores what the other wrote:

    <dir>/step_00000100/
        manifest.json        {step, leaves: [{name, file, shape, dtype,
                              stored_dtype, sha}]}
        leaf_00000.npy ...   one file per leaf of the reference's tree
        COMMIT               written last — a checkpoint without COMMIT is
                             ignored by restore (crash-atomicity)

A step is written into ``step_NNNNNNNN.tmp`` and renamed into place.
bfloat16 leaves are stored as their uint16 bits (logical ``dtype``
"bfloat16"). Leaves are written in the reference's flatten order under its
``jax.tree_util.keystr`` names: a ``TrainState``'s children are
``[<flat index i>]`` (params, opt, step, grad_err), dict keys are sorted,
and a parameter module (and the optimizer's ``m`` / ``v`` and the
error-feedback residual, which share its structure) is written in the
reference's layout, its layers stacked per block type
(``convert.lm_reference_leaves``). Restore matches leaves by order and
shape, as the reference does, and writes them into the target's tensors
in place (a stacked leaf unstacked into its layers). With ``shardings`` (a matching
tree of ``distributed.sharding.NamedSharding`` in the reference's layout)
restore places every leaf on its mesh instead, as the reference's
``device_put`` does, and returns the reference-layout tree of ``Sharded``
leaves.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import re
import shutil
import threading

import numpy as np
import torch
from torch import nn

from repro_torch.convert import lm_reference_leaves
from repro_torch.distributed import sharding
from repro_torch.train.step import TrainState


def _leaf_paths(tree, prefix: str = "") -> list:
    """``(name, leaf)`` in the reference's flatten order; a leaf is a
    tensor, or the list of tensors that the reference stacks into one."""
    if tree is None:
        return []
    if isinstance(tree, TrainState):
        children = (tree.params, tree.opt, tree.step, tree.grad_err)
        return [x for i, c in enumerate(children)
                for x in _leaf_paths(c, f"{prefix}[<flat index {i}>]")]
    if isinstance(tree, nn.Module):
        return _leaf_paths(lm_reference_leaves(tree), prefix)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_paths(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def _shape(leaf) -> list:
    if isinstance(leaf, list):
        return [len(leaf), *leaf[0].shape]
    return list(leaf.shape)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` (stacked if a list) as numpy, and its
    logical dtype name; bfloat16 as its uint16 bits."""
    if isinstance(leaf, list):
        t = torch.stack([x.detach().cpu() for x in leaf])
    else:
        t = leaf.detach().to("cpu", memory_format=torch.contiguous_format, copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _host_leaves(tree) -> list:
    return [(name, *_to_host(leaf)) for name, leaf in _leaf_paths(tree)]


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _write(directory: str, step: int, leaves) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": int(step), "leaves": []}
    for i, (name, arr, logical_dtype) in enumerate(leaves):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "name": name, "file": fname, "shape": list(arr.shape),
            "dtype": logical_dtype, "stored_dtype": str(arr.dtype),
            "sha": _digest(os.path.join(tmp, fname)),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def save_checkpoint(directory: str, step: int, tree) -> str:
    """Blocking save. Returns the checkpoint path."""
    return _write(directory, step, _host_leaves(tree))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    best = None
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, "COMMIT")):
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def _from_stored(arr: np.ndarray, meta: dict) -> torch.Tensor:
    if meta.get("stored_dtype", meta["dtype"]) == meta["dtype"]:
        return torch.from_numpy(arr)
    if meta["dtype"] != "bfloat16":
        raise ValueError(f"{meta['name']}: cannot read logical dtype {meta['dtype']}")
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


@torch.no_grad()
def restore_checkpoint(directory: str, step: int, target_tree, shardings=None, *,
                       verify: bool = True):
    """Restore into ``target_tree`` in place (shapes must match; values are
    cast to the target's dtypes and copied to its devices) and return it.

    ``shardings``: a tree of ``NamedSharding`` matching the target leaf for
    leaf in the reference's layout (``distributed.sharding.tree_items``
    order) — restore onto a mesh, as for an elastic restart. The target
    then gives only shapes and dtypes (it may live on ``meta``) and is left
    as it is; the result is the target's reference-layout tree (a
    ``TrainState`` stays one) of ``Sharded`` leaves, each entry's slice in
    the target's dtype on the entry's device."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _leaf_paths(target_tree)
    if len(manifest["leaves"]) != len(flat):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"target has {len(flat)}")
    for meta, (_, tgt) in zip(manifest["leaves"], flat):
        if list(meta["shape"]) != _shape(tgt):
            raise ValueError(f"shape mismatch {meta['name']}: "
                             f"{meta['shape']} vs {_shape(tgt)}")
    if shardings is not None:
        shard_flat = [s for _, s in sharding.tree_items(shardings)]
        if len(shard_flat) != len(flat):
            raise ValueError(f"{len(shard_flat)} shardings for {len(flat)} leaves")
    placed = []
    for i, (meta, (_, tgt)) in enumerate(zip(manifest["leaves"], flat)):
        fpath = os.path.join(path, meta["file"])
        if verify and _digest(fpath) != meta["sha"]:
            raise IOError(f"checksum mismatch in {fpath}")
        src = _from_stored(np.load(fpath), meta)
        if shardings is not None:
            dtype = (tgt[0] if isinstance(tgt, list) else tgt).dtype
            placed.append(sharding.place(src, shard_flat[i], dtype=dtype))
        elif isinstance(tgt, list):
            for t, s in zip(tgt, src):
                t.copy_(s)
        else:
            tgt.copy_(src)
    if shardings is None:
        return target_tree
    it = iter(placed)
    return sharding.tree_map(lambda *_: next(it), target_tree)


class AsyncCheckpointer:
    """Background-thread checkpoint writer (one in flight, latest wins)."""

    def __init__(self, directory: str):
        self.directory = directory
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self.last_error = None

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, leaves = item
            try:
                _write(self.directory, step, leaves)
            except Exception as e:  # surfaced on close
                self.last_error = e

    def save(self, step: int, tree):
        # host copies now, so the caller may go on updating its tensors
        leaves = _host_leaves(tree)
        try:
            self._q.put_nowait((step, leaves))
        except queue.Full:  # previous save still queued: skip (latest wins)
            pass

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self.last_error:
            raise self.last_error
