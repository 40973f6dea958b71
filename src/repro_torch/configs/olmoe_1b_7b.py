"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L d_model=2048 16H (GQA kv=16)
d_ff(expert)=1024 vocab=50304, MoE 64 experts top-8, no shared experts."""
from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,                    # per-expert FFN width
    vocab_size=50304,
    norm="rmsnorm",
    ffn="swiglu",
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024, n_shared=0),
))
