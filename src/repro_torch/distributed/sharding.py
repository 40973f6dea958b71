"""Sharding rules: param/optimizer/cache/batch partition specs, and the
placement of a tree on a mesh by them.

Counterpart of ``repro.distributed.sharding``, with its rule tables copied.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
  * pod+data — pure data parallelism (batch dim);
  * model    — tensor parallelism (attention heads / FFN hidden / vocab),
               expert parallelism (MoE expert dim) and sequence-sharded KV
               for long-context decode.

Rules are *name-based* and aligned to the TRAILING dims of each leaf, so the
same rule works for one layer and for the layers stacked per block type
(the leading stack dim takes None).

ZeRO-1: optimizer m/v get the param spec PLUS the largest remaining
unsharded dim sharded over "data" when divisible.

The rules run on the reference's layout of the port's trees: a parameter
module (or the optimizer's ``m`` / ``v`` copies of it) is read as
``convert.lm_reference_leaves`` gives it, nested dicts whose leaves the
reference stacks over layers become :class:`Stacked` leaves of the stacked
shape, without a copy. A ``TrainState`` flattens as the reference's does
(params, opt, step, grad_err), dicts by sorted key, None has no leaves, so
every spec tree lines up leaf for leaf with the reference's.

A spec is the port's :class:`PartitionSpec` (alias ``P``): a tuple with
one entry per leading dim, None, an axis name, or a tuple of names (the
dim split over their product, the first name major). :func:`place` lays a
tensor out on a mesh by a :class:`NamedSharding` as ``jax.device_put``
does: each mesh entry gets its own tensor, on its own device, holding the
slice that the reference's ``addressable_shards`` hold at that position.
ZeRO-1 may put ``data`` on a stack dim (it takes the largest divisible
dim); a :class:`Stacked` leaf then deals whole layers to the entries.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.convert import lm_reference_leaves
from repro_torch.distributed.mesh import Mesh
from repro_torch.train.step import TrainState


class PartitionSpec(tuple):
    """``P("data", None, ("pod", "model"))``: per leading dim, None
    (replicated), a mesh axis name, or a tuple of names; dims past its
    length are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec

# name -> spec for the trailing dims (len == expected trailing rank)
_PARAM_RULES: dict[str, tuple] = {
    # embeddings / unembedding
    "embed": ("model", None),          # vocab-sharded
    "unembed": (None, "model"),
    "pos_dec": (None, None),
    # attention
    "wq": (None, "model", None),
    "wk": (None, "model", None),
    "wv": (None, "model", None),
    "wo": ("model", None, None),
    "bq": ("model", None),
    "bk": ("model", None),
    "bv": ("model", None),
    "bo": (None,),
    # MLA
    "w_dkv": (None, None),             # latent is small; replicate
    "w_uk": (None, "model", None),
    "w_uv": (None, "model", None),
    # dense FFN
    "w_gate": (None, "model"),
    "w_up": (None, "model"),
    "w_down": ("model", None),
    "w_in": (None, "model"),
    "b_in": ("model",),
    "w_out": ("model", None),
    "b_out": (None,),
    # MoE router (the expert tensors are matched by _MOE_EXPERT_RULES)
    "router": (None, None),
    # RG-LRU
    "w_in_main": (None, "model"),
    "w_in_gate": (None, "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "w_a": (None, "model"),
    "b_a": ("model",),
    "w_x": (None, "model"),
    "b_x": ("model",),
    "lam": ("model",),
    # xLSTM
    "w_q": (None, "model"),
    "w_k": (None, "model"),
    "w_v": (None, "model"),
    "w_i": (None, None),
    "w_f": (None, None),
    "b_i": (None,),
    "b_f": (None,),
    "out_scale": ("model",),
    "w_zifo": (None, "model"),
    "b_zifo": ("model",),
    "r_z": (None, None, None),
    "r_i": (None, None, None),
    "r_f": (None, None, None),
    "r_o": (None, None, None),
    "ffn_up": (None, "model"),
    "ffn_down": ("model", None),
    # norms
    "scale": (None,),
    "bias": (None,),
}

# MoE expert tensors: (E, D, F)-shaped leaves under an "ffn" subtree.
_MOE_EXPERT_RULES = {
    "w_gate": ("model", None, None),
    "w_up": ("model", None, None),
    "w_down": ("model", None, None),
}


# ---------------------------------------------------------------------------
# trees in the reference's layout
# ---------------------------------------------------------------------------


class Stacked:
    """A leaf the reference stacks over layers: the layers' tensors in
    stack order, read as one leaf of shape (n_layers, *layer shape)
    without being stacked. ``x[idx]`` stacks the selected layers' slices."""

    def __init__(self, layers):
        self.layers = list(layers)
        first = self.layers[0]
        self.shape = torch.Size((len(self.layers), *first.shape))
        self.dtype = first.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def element_size(self) -> int:
        return self.layers[0].element_size()

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        rest = idx[1:]
        return torch.stack([t.detach()[rest] for t in self.layers[idx[0]]])

    def __repr__(self) -> str:
        return f"Stacked({tuple(self.shape)}, {self.dtype})"


def reference_layout(module: nn.Module) -> dict:
    """An LM parameter module (or a copy of its structure) as the
    reference's nested dicts, the stacked leaves as :class:`Stacked`."""
    def wrap(t):
        if isinstance(t, dict):
            return {k: wrap(v) for k, v in t.items()}
        return Stacked(t) if isinstance(t, list) else t
    return wrap(lm_reference_leaves(module))


def _children(tree):
    """``[(name, child)]`` of a container in the reference's flatten order,
    or None for a leaf."""
    if isinstance(tree, PartitionSpec):
        return None
    if isinstance(tree, TrainState):
        return list(enumerate((tree.params, tree.opt, tree.step, tree.grad_err)))
    if isinstance(tree, nn.Module):
        return sorted(reference_layout(tree).items())
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_items(tree, path: tuple = ()) -> list:
    """``(names, leaf)`` of every leaf in the reference's flatten order;
    ``names`` are the dict keys and indices on the way to it (as strings)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    return [x for k, c in kids for x in tree_items(c, path + (str(k),))]


def tree_map(fn, tree, *rest):
    """``fn(names, leaf, *rest_leaves)`` over ``tree``'s leaves, in its
    reference structure: a ``TrainState`` stays one, a module becomes its
    reference dicts, dicts, lists and tuples keep their type, None stays.
    Each of ``rest`` is flattened by :func:`tree_items` and matched by
    order."""
    its = [iter([leaf for _, leaf in tree_items(r)]) for r in rest]

    def build(t, p):
        if t is None:
            return None
        kids = _children(t)
        if kids is None:
            return fn(p, t, *(next(i) for i in its))
        out = {k: build(c, p + (str(k),)) for k, c in kids}
        if isinstance(t, TrainState):
            return TrainState(*(out[i] for i in range(4)))
        if isinstance(t, (list, tuple)):
            return type(t)(out[i] for i in range(len(t)))
        if isinstance(t, dict):
            return {k: out[k] for k in t}
        return out

    result = build(tree, ())
    for i in its:
        if next(i, None) is not None:
            raise ValueError("trees differ in their number of leaves")
    return result


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _spec_for(names, leaf) -> P:
    name = names[-1] if names else ""
    rule = _PARAM_RULES.get(name)
    if rule is None:
        return P()
    k = len(rule)
    if leaf.ndim < k:
        return P()
    return P(*((None,) * (leaf.ndim - k) + tuple(rule)))


def param_pspecs(params, *, moe: bool = False):
    """Spec tree matching ``params`` (a module or its reference dicts).

    ``moe=True`` switches ffn/{w_gate,w_up,w_down} to expert-parallel rules
    (those leaves are (L, E, D, F) instead of (L, D, F))."""

    def spec(names, leaf):
        name = names[-1] if names else ""
        if moe and "ffn" in names and name in _MOE_EXPERT_RULES \
                and "shared" not in names:
            rule = _MOE_EXPERT_RULES[name]
            return P(*((None,) * (leaf.ndim - 3) + tuple(rule)))
        return _spec_for(names, leaf)

    return tree_map(spec, params)


def opt_state_pspecs(params, pspecs, *, data_axis="data", mesh_axis_size=16,
                     moe: bool = False):
    """ZeRO-1: m/v = param spec + biggest unsharded dim -> data."""

    def zero1(_, p, spec):
        parts = list(spec) + [None] * (p.ndim - len(spec))
        best, best_size = None, 0
        for i, (dim, sp) in enumerate(zip(p.shape, parts)):
            if sp is None and dim % mesh_axis_size == 0 and dim > best_size:
                best, best_size = i, dim
        if best is not None:
            parts[best] = data_axis
        return P(*parts)

    mv = tree_map(zero1, params, pspecs)
    return {"m": mv, "v": mv, "step": P()}


def batch_pspecs(batch, *, data_axes=("data",)):
    """Shard the batch dim over (pod+)data; everything else replicated."""
    da = tuple(data_axes)
    spec_da = da[0] if len(da) == 1 else da

    def spec(names, leaf):
        name = names[-1] if names else ""
        if name == "positions3":               # (3, B, S)
            return P(None, spec_da, None)
        if name == "index":                    # scalar decode index
            return P()
        return P(*((spec_da,) + (None,) * (leaf.ndim - 1)))

    return tree_map(spec, batch)


def cache_pspecs(cache, *, data_axes=("data",), model_axis="model",
                 model_size=16):
    """KV/state caches: batch over (pod+)data; model axis goes to KV heads
    when divisible, else to the sequence dim (split-K decode); recurrent
    states shard their channel dim."""
    da = tuple(data_axes)
    spec_da = da[0] if len(da) == 1 else da

    def spec(names, leaf):
        name = names[-1] if names else ""
        nd = leaf.ndim
        if name in ("k", "v", "ck", "cv") and nd == 5:
            # (L, B, S, KV, hd)
            kv = leaf.shape[3]
            if kv % model_size == 0:
                return P(None, spec_da, None, model_axis, None)
            return P(None, spec_da, model_axis, None, None)
        if name == "ckv" and nd == 4:          # (L, B, S, r)
            return P(None, spec_da, model_axis, None)
        if name == "conv" and nd == 4:         # (L, B, K-1, C)
            return P(None, spec_da, None, model_axis)
        if name == "h" and nd == 3:            # (L, B, C)
            return P(None, spec_da, model_axis)
        if name == "C" and nd == 5:            # (L, B, NH, dk, dv)
            return P(None, spec_da, None, None, model_axis)
        if name in ("n",) and nd == 4:         # (L, B, NH, dk)
            return P(None, spec_da, None, None)
        if name == "m" and nd == 3:            # (L, B, NH)
            return P(None, spec_da, None)
        if nd >= 2:                            # sLSTM c/n/h/m (L, B, D)
            return P(None, spec_da) if nd == 2 else \
                P(*((None, spec_da) + (None,) * (nd - 2)))
        return P()

    return tree_map(spec, cache)


def _axis_size(mesh, ax) -> int:
    axes = ax if isinstance(ax, tuple) else (ax,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def enforce_divisibility(pspecs, tree, mesh):
    """Replicate any dim whose size isn't divisible by its mesh axes.

    Non-divisible cases are real and expected at fixed TP degree — e.g.
    GQA kv-heads (8) < model axis (16), 24-head attention on a 16-way
    axis, batch 1 on a 16-way data axis — and the standard answer is to
    replicate that dim while other dims keep their sharding. ``mesh`` needs
    only a ``shape`` mapping axis names to sizes."""

    def fix(_, spec, leaf):
        if not isinstance(spec, P) or not hasattr(leaf, "ndim"):
            return spec
        parts = list(spec) + [None] * (leaf.ndim - len(spec))
        for i, ax in enumerate(parts[:leaf.ndim]):
            if ax is not None and leaf.shape[i] % _axis_size(mesh, ax) != 0:
                parts[i] = None
        return P(*parts[:leaf.ndim])

    return tree_map(fix, pspecs, tree)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where each entry's slice of a leaf lives."""
    mesh: Mesh
    spec: PartitionSpec

    def indices(self, shape) -> np.ndarray:
        """Each mesh entry's slice of a leaf of ``shape`` (a tuple of
        ``slice`` per dim), laid out like ``mesh.devices``; raises where a
        sharded dim does not divide."""
        mesh, spec = self.mesh, tuple(self.spec)
        if len(spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"{len(shape)} dims of {tuple(shape)}")
        used = [a for ax in spec if ax is not None
                for a in (ax if isinstance(ax, tuple) else (ax,))]
        if len(used) != len(set(used)) or not set(used) <= set(mesh.axis_names):
            raise ValueError(f"spec {self.spec} does not fit mesh axes {mesh.axis_names}")
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, ax in enumerate(parts):
            if ax is not None and shape[i] % _axis_size(mesh, ax) != 0:
                raise ValueError(f"dim {i} of {tuple(shape)} ({shape[i]}) does not "
                                 f"divide over {ax!r} ({_axis_size(mesh, ax)}) in {self.spec}")
        out = np.empty(mesh.devices.shape, dtype=object)
        for pos in np.ndindex(*mesh.devices.shape):
            coord = dict(zip(mesh.axis_names, pos))
            idx = []
            for n, ax in zip(shape, parts):
                if ax is None:
                    idx.append(slice(0, n))
                    continue
                k = 0
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    k = k * mesh.shape[a] + coord[a]
                size = n // _axis_size(mesh, ax)
                idx.append(slice(k * size, (k + 1) * size))
            out[pos] = tuple(idx)
        return out


class Sharded:
    """A leaf placed on a mesh: its global ``shape`` and ``dtype``, its
    ``sharding``, and ``shards``, one tensor per mesh entry on that entry's
    device (laid out like ``mesh.devices``; ``indices`` holds each one's
    slice of the global leaf). Entries that repeat a device hold distinct
    tensors."""

    def __init__(self, shape, dtype, sharding: NamedSharding, shards: np.ndarray,
                 indices: np.ndarray):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.sharding, self.shards, self.indices = sharding, shards, indices

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def full(self, device=None) -> torch.Tensor:
        """The global leaf gathered onto ``device`` (default: the first
        entry's); each distinct slice is copied once."""
        flat = list(self.shards.flat)
        dev = torch.device(device) if device is not None else flat[0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        seen = set()
        for s, idx in zip(flat, self.indices.flat):
            key = tuple((i.start, i.stop) for i in idx)
            if key not in seen:
                seen.add(key)
                out[idx] = s.to(dev)
        return out

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, {self.spec}, "
                f"mesh={self.mesh.shape})")


def place(x, sharding: NamedSharding, dtype=None) -> Sharded:
    """``x`` (a tensor, a :class:`Stacked` leaf or a :class:`Sharded`) laid
    out by ``sharding``, cast to ``dtype`` if given: every entry gets a new
    tensor with its slice, on its device."""
    if isinstance(x, Sharded):
        x = x.full(sharding.mesh.devices.flat[0])
    dtype = x.dtype if dtype is None else dtype
    indices = sharding.indices(tuple(x.shape))
    shards = np.empty(indices.shape, dtype=object)
    for pos in np.ndindex(*indices.shape):
        dev = sharding.mesh.devices[pos]
        idx = indices[pos]
        src = x[idx] if isinstance(x, Stacked) else x.detach()[idx]
        shape = tuple(i.stop - i.start for i in idx)
        shards[pos] = torch.empty(shape, dtype=dtype, device=dev).copy_(src)
    return Sharded(x.shape, dtype, sharding, shards, indices)


def named_sharding_tree(mesh, pspecs):
    return tree_map(lambda _, s: NamedSharding(mesh, s), pspecs)
