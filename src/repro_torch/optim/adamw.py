"""AdamW with float32 state over (possibly bf16) params + global-norm
clipping.

Counterpart of ``repro.optim.adamw``, in its order of operations. The
update is in place: params, ``m`` and ``v`` are overwritten under
``torch.no_grad()``, the counterpart of the reference launcher's
``donate_argnums=0`` (a second copy of a 3B model's float32 ``m`` / ``v``
does not fit beside the first). Each leaf's float32 work runs in at most
three temporaries of its size. Nothing here waits for the device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.treeutil import global_norm, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> dict:
    """float32 zeros ``m`` and ``v`` in the params' structure (a module's
    copy for a module) and an int32 ``step`` on the params' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step. ``grads`` matches ``params`` leaf for leaf (the same
    structure, or a list in ``tree_leaves(params)`` order). Updates
    ``params``, ``state["m"]`` and ``state["v"]`` in place and sets
    ``state["step"]``; returns ``(params, state, metrics)`` with
    ``metrics = {"grad_norm", "lr"}`` as float32 device tensors."""
    gnorm = global_norm(grads)
    clip = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    b1c = 1.0 - torch.pow(torch.full_like(gnorm, cfg.b1), step.float())
    b2c = 1.0 - torch.pow(torch.full_like(gnorm, cfg.b2), step.float())
    lr = torch.full_like(gnorm, cfg.lr) * lr_scale

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.to(torch.float32, copy=True).mul_(clip)
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.mul_(g).mul_(1 - cfg.b2))
        delta = torch.div(m, b1c)                            # mh
        torch.div(v, b2c, out=g).sqrt_().add_(cfg.eps)       # sqrt(vh) + eps
        delta.div_(g).add_(g.copy_(p).mul_(cfg.weight_decay))
        p.copy_(g.copy_(p).sub_(delta.mul_(lr)))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
