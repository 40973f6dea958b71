"""Int8 error-feedback gradient compression for cross-pod all-reduce.

Counterpart of ``repro.optim.compression``. Each leaf is compressed to
int8 with a per-tensor float32 scale; the residual re-enters the next
step, so the update stays unbiased in the long run, and the bytes a
cross-pod all-reduce moves fall 4x (float32) / 2x (bf16).

Usage (inside train_step, around the optimizer):
    comp, err = compress_with_feedback(grads, err)
    grads = decompress(comp)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.utils.treeutil import tree_leaves, tree_map, tree_unflatten_like


class Compressed(NamedTuple):
    q: torch.Tensor       # int8 payload
    scale: torch.Tensor   # () float32


def _compress_leaf(g, e):
    gf = g.float() + e
    scale = torch.clamp(torch.amax(torch.abs(gf)), min=1e-12) / 127.0
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return Compressed(q, scale), gf - deq


def compress_with_feedback(grads, err):
    """grads, err: matching trees. Returns (compressed tree in ``grads``'s
    structure, new err in ``err``'s)."""
    out = [_compress_leaf(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    comp = tree_unflatten_like(grads, [o[0] for o in out])
    return comp, tree_unflatten_like(err, [o[1] for o in out])


def _is_compressed(x) -> bool:
    return isinstance(x, Compressed)


def decompress(comp):
    return tree_map(lambda c: c.q.float() * c.scale, comp, is_leaf=_is_compressed)


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
