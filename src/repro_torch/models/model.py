"""Unified model facade: one object per architecture with
init / loss / prefill / decode entry points, used by ``launch/serve.py``
and ``launch/train.py``.

Counterpart of ``repro.models.model``. Parameters and caches are created
on the device the caller names; ``None`` means the card and raises without
one (:func:`repro_torch._device.resolve_device`). The audio family runs
the Whisper encoder-decoder (``models/whisper.py``), every other family
the decoder of ``models/transformer.py``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    max_seq: int = 4096           # KV/positions capacity for serving caches
    chunk: int = 1024             # attention q-chunk
    remat: bool = False           # checkpoint each block in loss_fn's backward

    @property
    def _audio(self) -> bool:
        return self.cfg.family == "audio"

    # ---------------- params ----------------
    def _init(self, generator, device):
        if self._audio:
            return W.init_params(generator, self.cfg, device, max_dec_seq=self.max_seq)
        return T.init_params(generator, self.cfg, device)

    def init_params(self, generator: torch.Generator, device=None):
        """Random init from ``generator``, which must live on ``device``."""
        return self._init(generator, resolve_device(device))

    def param_specs(self):
        """The parameters' shapes and dtypes, on the ``meta`` device (no
        memory is allocated)."""
        return self._init(None, torch.device("meta"))

    # ---------------- training ----------------
    def loss_fn(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy plus the MoE aux loss, a float32
        scalar that autograd differentiates (``train/step.py``); with
        ``remat`` each block's activations are recomputed in the backward
        pass."""
        cfg, kw = self.cfg, {"chunk": self.chunk, "remat": self.remat}
        if self._audio:
            enc = W.encode(params, cfg, batch["frame_embeds"], **kw)
            hidden, _ = W.decode(params, cfg, batch["tokens"], enc_out=enc, **kw)
            return _ce_loss_whisper(params, hidden, batch)
        hidden, _, aux = T.forward(params, cfg, batch["tokens"], **kw,
                                   **self._vlm_kw(batch, "vision_embeds"))
        return T.lm_loss(params, cfg, hidden, batch["targets"], batch["mask"]) + aux

    # ---------------- serving ----------------
    def init_cache(self, batch_size: int, max_seq: int | None = None,
                   enc_seq: int | None = None, *, device=None):
        S = max_seq or self.max_seq
        dev = resolve_device(device)
        if self._audio:
            return W.init_cache(self.cfg, batch_size, S, enc_seq or S, dev)
        return T.init_cache(self.cfg, batch_size, S, dev)

    @torch.no_grad()
    def prefill(self, params, batch, cache):
        """Prefill ``batch["tokens"]`` (and, for audio, encode
        ``batch["frame_embeds"]``) into ``cache``; returns the last
        position's logits (B, 1, V) and the cache."""
        cfg = self.cfg
        if self._audio:
            enc = W.encode(params, cfg, batch["frame_embeds"], chunk=self.chunk)
            hidden, cache = W.decode(params, cfg, batch["tokens"], enc_out=enc,
                                     cache=cache, chunk=self.chunk)
            return W.lm_head(params, hidden[:, -1:]), cache
        hidden, cache, _ = T.forward(params, cfg, batch["tokens"], cache=cache,
                                     chunk=self.chunk,
                                     **self._vlm_kw(batch, "vision_embeds"))
        return T.lm_head(params, cfg, hidden[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, params, cache, batch):
        """batch: {"token": (B,1), "index": int, ["positions3"]}."""
        cfg = self.cfg
        if self._audio:
            hidden, cache = W.decode(params, cfg, batch["token"], cache=cache,
                                     cache_index=batch["index"], chunk=self.chunk)
            return W.lm_head(params, hidden), cache
        hidden, cache, _ = T.forward(params, cfg, batch["token"], cache=cache,
                                     cache_index=batch["index"], chunk=self.chunk,
                                     **self._vlm_kw(batch))
        return T.lm_head(params, cfg, hidden), cache

    def _vlm_kw(self, batch, *names) -> dict:
        if self.cfg.family != "vlm":
            return {}
        return {"positions3": batch.get("positions3"),
                **{n: batch[n] for n in names}}


def _ce_loss_whisper(params, hidden, batch):
    logits = W.lm_head(params, hidden).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["targets"].long()[..., None])[..., 0]
    m = batch["mask"].float()
    return torch.sum((logz - gold) * m) / torch.clamp(torch.sum(m), min=1.0)


def build_model(cfg: ArchConfig, **kw) -> Model:
    return Model(cfg=cfg, **kw)
