"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (GQA kv=16)
d_ff=1408 (per expert) vocab=163840, MoE 64e top-6 (+2 shared experts,
DeepSeek-style).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=163840,
        rope_theta=50_000.0,
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared_experts=2),
        source="hf:moonshotai/Moonlight-16B-A3B",
    )
