"""rwkv6-3b (Finch) — attention-free, data-dependent decay linear recurrence.

[arXiv:2404.05892; hf]  32L d_model=2560 d_ff=8960 vocab=65536, head_dim 64.
"""
from repro_torch.configs.base import ModelConfig, RecurrentConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,             # 2560 / 64 rwkv heads
        n_kv_heads=40,
        head_dim=64,
        d_ff=8960,
        vocab_size=65536,
        mixer_pattern=("rwkv",),
        pos_kind="none",
        act="rwkv_channel_mix",
        norm="ln",
        recurrent=RecurrentConfig(rwkv_head_dim=64, chunk_size=128),
        source="arXiv:2404.05892",
    )
