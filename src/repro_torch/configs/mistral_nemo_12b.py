"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407; hf]: 40L
d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072, 128k ctx."""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    norm="rmsnorm",
    ffn="swiglu",
    rope_theta=1000000.0,
))
