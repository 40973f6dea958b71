"""Qwen2-VL-7B [arXiv:2409.12191; hf]: 28L d_model=3584 28H (GQA kv=4)
d_ff=18944 vocab=152064 — M-RoPE (t/h/w sections 16/24/24), dynamic
resolution. The vision frontend is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings + 3D position ids."""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    norm="rmsnorm",
    ffn="swiglu",
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    tp_pad_heads_to=16,   # 28 heads -> 32 (§Perf)
))
