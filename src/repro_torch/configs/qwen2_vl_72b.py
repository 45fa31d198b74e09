"""qwen2-vl-72b — VLM backbone (text transformer only; ViT frontend is a stub).

[arXiv:2409.12191; hf]  80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE (t,h,w) = (16,24,24) over head_dim 128.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
        source="arXiv:2409.12191",
    )
