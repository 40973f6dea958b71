"""Unified model facade: one object per architecture with
init / loss / prefill / decode entry points, used by ``launch/serve.py``.

Counterpart of ``repro.models.model``. Parameters and caches are created
on the device the caller names; ``None`` means the card and raises without
one (:func:`repro_torch._device.resolve_device`). The audio family
(Whisper) is ROADMAP queue 1 item 9 (b) and raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    max_seq: int = 4096           # KV/positions capacity for serving caches
    chunk: int = 1024             # attention q-chunk

    def _check_family(self) -> None:
        if self.cfg.family == "audio":
            raise T._not_ported(f"the audio family ({self.cfg.name})")

    # ---------------- params ----------------
    def init_params(self, generator: torch.Generator, device=None) -> T.LMParams:
        """Random init from ``generator``, which must live on ``device``."""
        self._check_family()
        return T.init_params(generator, self.cfg, resolve_device(device))

    def param_specs(self) -> T.LMParams:
        """The parameters' shapes and dtypes, on the ``meta`` device (no
        memory is allocated)."""
        self._check_family()
        return T.init_params(None, self.cfg, torch.device("meta"))

    # ---------------- training ----------------
    def loss_fn(self, params: T.LMParams, batch) -> torch.Tensor:
        """Mean next-token cross-entropy (the forward value; the backward
        pass is ROADMAP queue 1 item 9 (c))."""
        self._check_family()
        hidden, _ = T.forward(params, self.cfg, batch["tokens"], chunk=self.chunk,
                              **self._vlm_kw(batch, "vision_embeds"))
        return T.lm_loss(params, self.cfg, hidden, batch["targets"], batch["mask"])

    # ---------------- serving ----------------
    def init_cache(self, batch_size: int, max_seq: int | None = None, *,
                   device=None):
        self._check_family()
        return T.init_cache(self.cfg, batch_size, max_seq or self.max_seq,
                            resolve_device(device))

    @torch.no_grad()
    def prefill(self, params: T.LMParams, batch, cache):
        """Prefill ``batch["tokens"]`` into ``cache``; returns the last
        position's logits (B, 1, V) and the cache."""
        self._check_family()
        hidden, cache = T.forward(params, self.cfg, batch["tokens"], cache=cache,
                                  chunk=self.chunk,
                                  **self._vlm_kw(batch, "vision_embeds"))
        return T.lm_head(params, self.cfg, hidden[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, params: T.LMParams, cache, batch):
        """batch: {"token": (B,1), "index": int, ["positions3"]}."""
        self._check_family()
        hidden, cache = T.forward(params, self.cfg, batch["token"], cache=cache,
                                  cache_index=batch["index"], chunk=self.chunk,
                                  **self._vlm_kw(batch))
        return T.lm_head(params, self.cfg, hidden), cache

    def _vlm_kw(self, batch, *names) -> dict:
        if self.cfg.family != "vlm":
            return {}
        return {"positions3": batch.get("positions3"),
                **{n: batch[n] for n in names}}


def build_model(cfg: ArchConfig, **kw) -> Model:
    return Model(cfg=cfg, **kw)
