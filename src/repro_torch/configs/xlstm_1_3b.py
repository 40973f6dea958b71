"""xLSTM-1.3B [arXiv:2405.04517; unverified]: 48 blocks d_model=2048 4H,
d_ff=0 (projection lives inside the block), vocab=50304, xLSTM[7:1] —
7 mLSTM blocks per 1 sLSTM block.

sub_quadratic=True: constant-size recurrent state (matrix memory C for
mLSTM, scalar memory for sLSTM) ⇒ long_500k decode runs for this arch.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    norm="rmsnorm",
    ffn="none",
    rope_theta=0.0,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    slstm_every=8,
    conv_width=4,
    sub_quadratic=True,
))
