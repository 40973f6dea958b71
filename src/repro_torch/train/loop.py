"""Fault-tolerant training loop: checkpoint/restart, stragglers.

Counterpart of ``repro.train.loop``:
  * resume from the latest committed checkpoint on (re)start — crash
    atomicity comes from the COMMIT protocol in ``checkpoint/ckpt.py``;
  * async checkpointing every ``ckpt_every`` steps and at the last step
    (training never blocks on the filesystem);
  * per-step deadline watchdog — a step longer than ``straggler_factor`` x
    the trailing median of 20 step times (once 5 are known) is counted and
    logged as a straggler;
  * failure injection (``fail_at``) to exercise restart in tests.

The one host sync a step is ``float(metrics["loss"])``; the step's time is
taken after it.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Iterator

import numpy as np

from repro_torch.checkpoint.ckpt import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.train.step import TrainState


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    straggler_factor: float = 3.0
    log_every: int = 10
    fail_at: int | None = None      # inject a crash at this step (tests)


class SimulatedFailure(RuntimeError):
    pass


def run_training(train_step: Callable, state: TrainState,
                 batches: Iterator[Any], cfg: LoopConfig,
                 *, shardings=None, logger=print) -> tuple[TrainState, dict]:
    """Run (or resume) training. Returns (final state, stats).

    ``shardings`` passes through to ``restore_checkpoint``: a resumed
    state then comes back placed on its mesh (``Sharded`` leaves in the
    reference's layout), for a ``train_step`` that takes it so."""
    start = latest_step(cfg.ckpt_dir)
    if start is not None:
        logger(f"[loop] resuming from checkpoint step {start}")
        state = restore_checkpoint(cfg.ckpt_dir, start, state, shardings=shardings)
        start_step = start
    else:
        start_step = int(state.step)

    ckpt = AsyncCheckpointer(cfg.ckpt_dir)
    step_times: list[float] = []
    stragglers = 0
    losses = []

    try:
        for step in range(start_step, cfg.total_steps):
            if cfg.fail_at is not None and step == cfg.fail_at:
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = next(batches)
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            losses.append(float(metrics["loss"]))
            dt = time.perf_counter() - t0

            if len(step_times) >= 5:
                med = float(np.median(step_times[-20:]))
                if dt > cfg.straggler_factor * med:
                    stragglers += 1
                    logger(f"[loop] straggler step {step}: {dt:.3f}s "
                           f"(median {med:.3f}s)")
            step_times.append(dt)

            if step % cfg.log_every == 0:
                logger(f"[loop] step {step} loss={losses[-1]:.4f} "
                       f"dt={dt*1e3:.1f}ms")
            if (step + 1) % cfg.ckpt_every == 0 or step + 1 == cfg.total_steps:
                ckpt.save(step + 1, state)
    finally:
        ckpt.close()

    return state, {
        "losses": losses,
        "step_times": step_times,
        "stragglers": stragglers,
        "final_step": int(state.step),
    }
