"""Small tree helpers used across the training path.

Counterpart of ``repro.utils.treeutil``. A *tree* here is a module (its
``parameters()`` in registration order), a dict of trees (its keys
sorted, as ``jax.tree_util`` flattens dicts), a list or tuple of trees, a
tensor, or None (no leaves). The port keeps an LM's weights as one module
per layer, so over a module the leaf order is the module's, not the
reference's stacked-per-block-type order; over the reference's own layout
(nested dicts, as the optimizer tests feed) the two orders are equal.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of ``tree`` in flatten order; ``is_leaf(x)`` True stops
    the descent at ``x``."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


def tree_unflatten_like(tree, leaves, is_leaf=None):
    """``leaves`` (in ``tree_leaves(tree)`` order) in ``tree``'s structure.
    A module comes back as a copy of it whose parameters are ``leaves``
    (each taking a gradient where the leaf does); the module itself is
    left as it is."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if is_leaf is not None and is_leaf(t):
            return next(it)
        if isinstance(t, nn.Module):
            memo = {}
            for p in t.parameters():
                x = next(it)
                memo[id(p)] = nn.Parameter(x, requires_grad=x.requires_grad)
            return copy.deepcopy(t, memo)
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (each flattened the same way), in ``tree``'s structure."""
    leaves = [fn(*xs) for xs in zip(tree_leaves(tree, is_leaf),
                                    *(tree_leaves(r, is_leaf) for r in rest))]
    return tree_unflatten_like(tree, leaves, is_leaf)


def tree_count(tree) -> int:
    """Total number of scalar elements in a tree of tensors."""
    return int(sum(np.prod(x.shape) if hasattr(x, "shape") else 1
                   for x in tree_leaves(tree)))


def tree_bytes(tree) -> int:
    """Total bytes of a tree of tensors (``meta`` tensors included)."""
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)
                   if isinstance(x, torch.Tensor)))


def global_norm(tree) -> torch.Tensor:
    """L2 norm over all leaves: the per-leaf float32 sums of squares added
    in flatten order, then the square root; a 0-dim float32 tensor on the
    leaves' device (no host sync)."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(sum(sums))
