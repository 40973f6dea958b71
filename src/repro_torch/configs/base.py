"""Architecture config dataclasses for the 10 assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int               # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # always-on shared experts (DeepSeek style)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0         # 0 = direct q projection (V2-Lite)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int
    encoder_seq: int = 1500      # whisper-base 30 s — overridden by shapes


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | audio | hybrid | ssm | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    norm: str = "rmsnorm"        # rmsnorm | layernorm
    ffn: str = "swiglu"          # swiglu | mlp_gelu | none
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    encdec: Optional[EncDecConfig] = None

    # hybrid / ssm block structure
    block_pattern: tuple = ()    # e.g. ("rec", "rec", "attn"); empty = all attn
    local_window: int = 0        # sliding-window size for "attn" blocks when >0
    lru_width: int = 0           # RG-LRU state width (defaults to d_model)
    conv_width: int = 4          # temporal conv in recurrent blocks
    slstm_every: int = 0         # xLSTM: 1 sLSTM per this many blocks

    # vlm
    mrope_sections: tuple = ()   # e.g. (16, 24, 24) t/h/w — empty = plain RoPE

    # TP head padding (§Perf): pad n_heads up to this multiple with zero
    # output rows so attention shards over the model axis instead of
    # replicating (exact — padded heads contribute 0). 0 = off.
    tp_pad_heads_to: int = 0

    # training
    dtype: str = "bfloat16"

    # quadratic attention everywhere? (decides long_500k applicability)
    sub_quadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def scaled(self, **kw) -> "ArchConfig":
        """Reduced config of the same family (for smoke tests)."""
        return dataclasses.replace(self, **kw)


def reduced_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config: few layers, small width/vocab/experts."""
    kw = dict(
        n_layers=max(2, len(cfg.block_pattern) or 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 1,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=16,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=32,
            n_shared=min(cfg.moe.n_shared, 1))
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                              qk_rope_head_dim=8, v_head_dim=16)
        kw["head_dim"] = 0
    if cfg.encdec is not None:
        kw["encdec"] = EncDecConfig(n_encoder_layers=2, encoder_seq=32)
    if cfg.lru_width:
        kw["lru_width"] = 64
    if cfg.local_window:
        kw["local_window"] = 16
    if cfg.block_pattern and cfg.family == "ssm":
        kw["n_layers"] = 8  # one full 7:1 superblock
    if cfg.mrope_sections:
        kw["mrope_sections"] = (2, 3, 3)  # sums to reduced head_dim // 2
    kw["tp_pad_heads_to"] = 0         # no TP padding in reduced smokes
    return cfg.scaled(**kw)
