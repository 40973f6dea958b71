"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434; hf]: 27L d_model=2048 16H,
MLA kv_lora_rank=512, MoE 64 routed + 2 shared experts, top-6,
d_ff_expert=1408, vocab=102400.

Assignment-sheet note: the header says "MoE 64e top-6" while the detail line
says "2 shared+160 routed"; 160 routed is full DeepSeek-V2 — V2-*Lite* has 64
routed experts. We follow the header + the published V2-Lite config
(64 routed, 2 shared, top-6); recorded in DESIGN.md §Arch-applicability.
First layer uses a dense FFN (d_ff=10944) per the published config; we apply
MoE in all layers for layer-homogeneous scan (noted simplification).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,                # MLA: kv heads == heads, cache is latent
    d_ff=1408,
    vocab_size=102400,
    norm="rmsnorm",
    ffn="swiglu",
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128, q_lora_rank=0),
))
