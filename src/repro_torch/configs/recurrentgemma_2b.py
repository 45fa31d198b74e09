"""recurrentgemma-2b (Griffin) — RG-LRU + local attention, pattern 2:1.

[arXiv:2402.19427; hf]  26L d_model=2560 10H (MQA kv=1, head_dim 256)
d_ff=7680 vocab=256000, local window 2048, lru_width 2560.
"""
from repro_torch.configs.base import ModelConfig, RecurrentConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        mixer_pattern=("rglru", "rglru", "attn"),
        local_window=2048,
        act="swiglu",   # GeGLU in the paper; gated-linear either way
        rope_theta=10_000.0,
        recurrent=RecurrentConfig(lru_width=2560, conv_width=4, chunk_size=128),
        source="arXiv:2402.19427",
    )
