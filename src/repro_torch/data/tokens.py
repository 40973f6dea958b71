"""LM data pipeline: synthetic corpus with learnable structure.

Counterpart of ``repro.data.tokens``. Generates an infinite stream of
training batches from a deterministic Markov-ish synthetic corpus (token
t+1 = f(token t) + noise) so smoke training runs can demonstrably reduce
loss. Every draw is the reference's numpy draw, in its order, so the
batches are bit-equal to the reference's; each global batch is made on
the host and copied to ``device``.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch._device import resolve_device


def synthetic_batches(cfg, *, batch: int, seq: int, family: str,
                      seed: int = 0, n_vision: int = 8,
                      device=None) -> Iterator[dict]:
    """Batches of ``tokens`` / ``targets`` (int32 (B, S)) and ``mask``
    (float32 ones), with ``frame_embeds`` (audio) or ``vision_embeds`` and
    ``positions3`` (int32 (3, B, S); vlm). The embeddings are drawn in
    float32 and rounded to the model dtype (round to nearest even, as
    ``jnp.asarray(..., dtype=bf16)`` rounds). ``device`` None is the card
    (raises without one)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    # deterministic successor table + noise: learnable bigram structure
    succ = rng.integers(0, V, size=(V,))

    def embeds(shape):
        x = rng.standard_normal(shape).astype(np.float32) * 0.1
        return torch.from_numpy(x).to(dev).to(dtype)

    while True:
        first = rng.integers(0, V, size=(batch, 1))
        toks = [first]
        for _ in range(seq):
            nxt = succ[toks[-1]]
            noise = rng.random((batch, 1)) < 0.1
            rand = rng.integers(0, V, size=(batch, 1))
            toks.append(np.where(noise, rand, nxt))
        arr = np.concatenate(toks, axis=1)
        b = {
            "tokens": torch.from_numpy(arr[:, :seq].astype(np.int32)).to(dev),
            "targets": torch.from_numpy(arr[:, 1:seq + 1].astype(np.int32)).to(dev),
            "mask": torch.ones((batch, seq), dtype=torch.float32, device=dev),
        }
        if family == "audio":
            b["frame_embeds"] = embeds((batch, seq, cfg.d_model))
        if family == "vlm":
            b["vision_embeds"] = embeds((batch, min(n_vision, seq), cfg.d_model))
            b["positions3"] = torch.arange(seq, dtype=torch.int32, device=dev)[
                None, None, :].expand(3, batch, seq).contiguous()
        yield b
