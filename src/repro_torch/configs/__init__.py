from repro_torch.configs.base import ArchConfig, MoEConfig, MLAConfig, EncDecConfig
from repro_torch.configs.registry import get_config, list_archs, register
from repro_torch.configs import shapes as shapes  # noqa: F401

# Import arch modules so they self-register.
from repro_torch.configs import (  # noqa: F401
    olmoe_1b_7b,
    deepseek_v2_lite_16b,
    llama3_2_3b,
    deepseek_7b,
    starcoder2_15b,
    mistral_nemo_12b,
    whisper_base,
    recurrentgemma_9b,
    xlstm_1_3b,
    qwen2_vl_7b,
)
