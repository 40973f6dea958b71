"""LR schedules (counterpart of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step: torch.Tensor, *, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_frac. Returns a multiplier: a
    float32 tensor on ``step``'s device, computed in float32 in the
    reference's order (Python constants rounded to float32 as JAX's weak
    types round them)."""
    step = step.float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
