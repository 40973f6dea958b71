"""Training step: loss + grad (+microbatch accumulation) + AdamW update.

Counterpart of ``repro.train.step``. Microbatching splits the global batch
along dim 0 (``positions3`` along dim 1) and runs a Python loop over the
microbatches, accumulating float32 gradients — the standard
grad-accumulation pattern that bounds activation memory at large global
batch; the reference scans the same loop. Remat is applied at the block
level inside the model (``Model(remat=True)``).

Optional int8 error-feedback gradient compression (``optim/compression.py``)
is applied before the update when enabled. The step is one eager function:
autograd for the gradients, then ``adamw_update`` in place on the state's
params and ``m`` / ``v``. Nothing in it waits for the device: the loss
comes back as a device tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch._device import resolve_device
from repro_torch.models.model import Model
from repro_torch.optim import compression as comp
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.utils.treeutil import tree_leaves


@dataclasses.dataclass
class TrainState:
    params: Any            # the model's parameter module
    opt: Any               # {"m", "v": float32 copies of params' structure, "step"}
    step: Any              # int32 0-dim tensor
    grad_err: Any = None   # error-feedback residual (compression only)


def init_train_state(model: Model, generator: torch.Generator, *,
                     use_compression: bool = False, device=None) -> TrainState:
    """Params from ``generator`` (which lives on ``device``; None is the
    card and raises without one), zero AdamW state and step."""
    dev = resolve_device(device)
    params = model.init_params(generator, dev)
    err = comp.init_error(params) if use_compression else None
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev), grad_err=err)


def microbatches(batch: dict, n: int) -> list[dict]:
    """``batch`` split into ``n`` equal microbatches along the batch dim
    (dim 1 of ``positions3``, dim 0 of everything else)."""
    def split(k, v):
        return v.chunk(n, dim=1 if k == "positions3" else 0)

    parts = {k: split(k, v) for k, v in batch.items()}
    if any(len(p) != n or p[0].shape != p[-1].shape for p in parts.values()):
        raise ValueError(f"the batch does not split into {n} equal microbatches")
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def value_and_grad(model: Model, params, batch: dict, n_microbatches: int = 1):
    """The loss and the gradient of every ``tree_leaves(params)`` leaf (a
    list in that order): one backward pass, or with ``n_microbatches`` > 1
    the float32 sums over the microbatches scaled by ``1 / n``, as the
    reference accumulates them."""
    leaves = tree_leaves(params)
    if n_microbatches == 1:
        loss = model.loss_fn(params, batch)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    for mb in microbatches(batch, n_microbatches):
        loss = model.loss_fn(params, mb)
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a.add_(g)
        loss_sum = loss_sum + loss.detach()
    inv = 1.0 / n_microbatches
    return loss_sum * inv, [a.mul_(inv) for a in acc]


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    n_microbatches: int = 1, warmup: int = 100,
                    total_steps: int = 10000, use_compression: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``. The state's
    params and ``m`` / ``v`` are updated in place and the same object comes
    back with its steps advanced; ``metrics`` (``loss``, ``grad_norm``,
    ``lr``) are device tensors."""

    def train_step(state: TrainState, batch):
        loss, grads = value_and_grad(model, state.params, batch, n_microbatches)
        new_err = state.grad_err
        if use_compression:
            compressed, new_err = comp.compress_with_feedback(grads, state.grad_err)
            grads = comp.decompress(compressed)
        lr_scale = cosine_schedule(state.step, warmup=warmup, total=total_steps)
        params, opt, metrics = adamw_update(state.params, grads, state.opt, opt_cfg,
                                            lr_scale=lr_scale)
        metrics["loss"] = loss
        state.params, state.opt, state.grad_err = params, opt, new_err
        state.step = state.step + 1
        return state, metrics

    return train_step
