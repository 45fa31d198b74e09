"""granite-moe-1b-a400m — MoE, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  24L d_model=1024 16H
(GQA kv=8) d_ff=512 (per expert) vocab=49155, MoE 32e top-8.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        rope_theta=10_000.0,
        moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
