"""GPipe-style pipeline parallelism over the devices of a "pipe" axis.

Counterpart of ``repro.distributed.pipeline``. The reference runs the
schedule inside ``shard_map``, one program per stage, and moves
activations with ``ppermute``; here one process drives every stage
(the port's one-controller design) and runs the same schedule step by
step: each stage holds a contiguous slab of layers on its own device,
the activation goes to the next stage's device with a non-blocking copy,
and the bubble is the standard (P-1)/(P-1+M) GPipe bubble.
"""
from __future__ import annotations

import torch


def pipeline_forward(layer_fn, stage_params, x, *, n_stages: int, n_micro: int,
                     devices):
    """Run the pipeline.

    layer_fn(params, x) -> x : one stage's computation (its layer slab)
    stage_params: a list of ``n_stages`` params, stage ``s``'s on
       ``devices[s]`` (the pipe axis's devices, which may repeat one)
    x: (n_micro, micro_batch, ...) microbatched input on ``devices[0]``

    At step t = 0 ... n_micro + n_stages - 2, stage s is active when
    0 <= t - s < n_micro; stage 0 injects micro-batch t, every other stage
    takes what the stage before it made at step t - 1. Returns the last
    stage's outputs in micro-batch order, (n_micro, micro_batch, ...) on
    ``devices[0]``: what the reference's caller reads from the first pipe
    shard."""
    devices = [torch.device(d) for d in devices]
    if not len(stage_params) == len(devices) == n_stages:
        raise ValueError(f"{n_stages} stages need as many params and devices, got "
                         f"{len(stage_params)} and {len(devices)}")
    if x.shape[0] < n_micro:
        raise ValueError(f"x has {x.shape[0]} micro-batches, n_micro is {n_micro}")
    inbox = [None] * n_stages             # the activation each stage takes next
    outs = []
    for t in range(n_micro + n_stages - 1):
        sent = [None] * n_stages
        for s in range(n_stages):
            if not 0 <= t - s < n_micro:
                continue
            y = layer_fn(stage_params[s], x[t] if s == 0 else inbox[s])
            if s == n_stages - 1:
                outs.append(y)
            else:
                sent[s + 1] = y.to(devices[s + 1], non_blocking=True)
        inbox = sent
    return torch.stack([y.to(devices[0], non_blocking=True) for y in outs])
