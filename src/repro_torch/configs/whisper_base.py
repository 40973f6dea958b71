"""Whisper-base [arXiv:2212.04356; unverified]: enc-dec, 6+6L d_model=512 8H
d_ff=2048 vocab=51865. Conv frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings to the encoder."""
from repro_torch.configs.base import ArchConfig, EncDecConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                  # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    norm="layernorm",
    ffn="mlp_gelu",
    rope_theta=0.0,              # whisper uses learned/sinusoidal positions
    tie_embeddings=True,
    encdec=EncDecConfig(n_encoder_layers=6, encoder_seq=1500),
))
