"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427; unverified]: 38L
d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000 — RG-LRU + local attention
in a 2:1 (recurrent:attention) repeating pattern, window 2048.

sub_quadratic=True: bounded local-attn KV + O(1) recurrent state ⇒ the
long_500k decode cell runs for this arch.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    norm="rmsnorm",
    ffn="swiglu",
    rope_theta=10000.0,
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    lru_width=4096,
    conv_width=4,
    sub_quadratic=True,
))
