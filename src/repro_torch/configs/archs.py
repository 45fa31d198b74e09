"""Import all assigned-architecture configs for registry side effects."""
from repro_torch.configs import (  # noqa: F401
    granite_moe_1b_a400m,
    minicpm3_4b,
    moonshot_v1_16b_a3b,
    phi3_medium_14b,
    qwen1_5_0_5b,
    qwen2_0_5b,
    qwen2_vl_72b,
    recurrentgemma_2b,
    rwkv6_3b,
    whisper_large_v3,
)
