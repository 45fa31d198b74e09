"""whisper-large-v3 — encoder-decoder audio transformer backbone.

[arXiv:2212.04356; unverified]  32L(enc)+32L(dec) d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866.  The conv/mel frontend is a STUB: ``input_specs()``
provides precomputed frame embeddings of shape (B, 1500, 1280).
"""
from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51866,
        act="gelu",
        norm="ln",
        pos_kind="learned",
        qkv_bias=True,
        is_encoder_decoder=True,
        n_encoder_layers=32,
        encoder_seq=1500,
        source="arXiv:2212.04356",
    )
