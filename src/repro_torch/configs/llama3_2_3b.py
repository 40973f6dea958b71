"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-3B; unverified]: 28L d_model=3072
24H (GQA kv=8) d_ff=8192 vocab=128256."""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    norm="rmsnorm",
    ffn="swiglu",
    rope_theta=500000.0,
    tie_embeddings=True,
    tp_pad_heads_to=16,   # 24 heads -> 32: shards on the 16-way model axis (§Perf)
))
