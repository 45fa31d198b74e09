"""minicpm3-4b — dense with MLA (multi-head latent attention).

[hf:openbmb/MiniCPM3-4B; hf]  62L d_model=2560 40H d_ff=6400 vocab=73448,
MLA: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        head_dim=96,   # qk_nope + qk_rope
        d_ff=6400,
        vocab_size=73448,
        attn_kind="mla",
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
        tie_embeddings=True,
        source="hf:openbmb/MiniCPM3-4B",
    )
