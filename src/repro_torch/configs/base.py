"""Config system of the port: a copy of the reference's
``configs/base.py``, changed only in its import paths and this
docstring, so that ``get_config`` / ``smoke_config`` / ``param_count``
answer as the reference's do.

Every assigned architecture is a ``ModelConfig`` instance registered under its
``--arch`` id.  Input shapes are ``ShapeConfig`` instances; the cross product
(arch x shape) defines the dry-run / roofline cells.

Pure Python: importing it touches no device.  The port's model runs
every registered config and its smoke config.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional

# --------------------------------------------------------------------------
# Model configuration
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0          # per-expert FFN hidden size
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class RecurrentConfig:
    """RG-LRU (Griffin) / RWKV-6 recurrent-mixer parameters."""
    lru_width: int = 0          # RG-LRU channel width (griffin)
    conv_width: int = 4         # temporal conv width (griffin)
    rwkv_head_dim: int = 64     # RWKV-6 per-head dim
    chunk_size: int = 128       # chunked-scan chunk length (training/prefill)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # token mixer selection, cycled over layers, e.g. ("rec","rec","attn")
    mixer_pattern: tuple = ("attn",)
    attn_kind: str = "gqa"      # gqa | mla
    qkv_bias: bool = False
    local_window: int = 0       # >0: sliding-window attention
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple] = None   # qwen2-vl M-RoPE (t,h,w) sections
    pos_kind: str = "rope"      # rope | learned | none

    act: str = "swiglu"         # swiglu | gelu
    norm: str = "rms"           # rms | ln
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    recurrent: Optional[RecurrentConfig] = None

    # encoder-decoder (whisper): stubbed modality frontend provides encoder
    # inputs as precomputed frame embeddings of shape (B, encoder_seq, d_model)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0

    # dtype policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # notes carried into DESIGN/EXPERIMENTS tables
    source: str = ""

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def padded_vocab(self, multiple: int = 2048) -> int:
        return int(math.ceil(self.vocab_size / multiple) * multiple)

    @property
    def is_attention_free(self) -> bool:
        return all(m != "attn" for m in self.mixer_pattern)

    @property
    def supports_long_context(self) -> bool:
        """True when decode state is O(1) or windowed (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> tuple:
        """Mixer kind for each decoder layer (pattern cycled)."""
        p = self.mixer_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    # ---- parameter counting (for MODEL_FLOPS = 6*N*D roofline term) ----
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        v = self.padded_vocab()

        def attn_params() -> int:
            if self.attn_kind == "mla":
                m = self.mla
                qk_dim = m.qk_nope_dim + m.qk_rope_dim
                p = d * m.q_lora_rank + m.q_lora_rank * n_q * qk_dim
                p += d * (m.kv_lora_rank + m.qk_rope_dim)
                p += m.kv_lora_rank * n_q * (m.qk_nope_dim + m.v_head_dim)
                p += n_q * m.v_head_dim * d
                return p
            p = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
            if self.qkv_bias:
                p += (n_q + 2 * n_kv) * hd
            return p

        def rec_params(kind: str) -> int:
            r = self.recurrent
            if kind == "rwkv":
                # r,k,v,g,o projections + decay/first params + token-shift mixes
                return 5 * d * d + 4 * d + 2 * d * 32  # lora decay approx
            # griffin RG-LRU block: in-proj (2x lru), conv, gates, out-proj
            lw = r.lru_width or d
            return d * 2 * lw + r.conv_width * lw + 2 * lw * lw // 8 + lw * d + 2 * lw

        def ffn_params() -> int:
            if self.moe is not None:
                e = self.moe
                per = 3 * d * e.d_expert if self.act == "swiglu" else 2 * d * e.d_expert
                router = d * e.n_experts
                n_e = (e.top_k + e.n_shared_experts) if active_only else (
                    e.n_experts + e.n_shared_experts)
                return per * n_e + router
            mult = 3 if self.act == "swiglu" else 2
            return mult * d * self.d_ff

        total = v * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds():
            mixer = attn_params() if kind == "attn" else rec_params(kind)
            total += mixer + ffn_params() + 2 * d  # + norms
        if self.is_encoder_decoder:
            # encoder self-attn + ffn, and decoder cross-attn
            enc = self.n_encoder_layers * (attn_params() + ffn_params() + 2 * d)
            cross = self.n_layers * attn_params()
            total += enc + cross
        return int(total)


# --------------------------------------------------------------------------
# Shapes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Assignment rule: long_500k only for sub-quadratic (ssm/hybrid) archs."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg_fn: Callable[[], ModelConfig]):
    cfg = cfg_fn()
    _REGISTRY[cfg.name] = cfg
    return cfg_fn


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # import arch modules for registration side effects
    if _REGISTRY:
        return
    from repro_torch.configs import archs  # noqa: F401


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    changes: dict = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(
            n_experts=4, top_k=min(cfg.moe.top_k, 2), d_expert=64,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1))
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                                   qk_nope_dim=16, qk_rope_dim=16, v_head_dim=16)
    if cfg.recurrent is not None:
        changes["recurrent"] = dataclasses.replace(
            cfg.recurrent, lru_width=128 if cfg.recurrent.lru_width else 0,
            rwkv_head_dim=32, chunk_size=16)
    if cfg.is_encoder_decoder:
        changes["n_encoder_layers"] = 2
        changes["encoder_seq"] = 16
    if cfg.local_window:
        changes["local_window"] = 32
    if cfg.mrope_sections is not None:
        changes["mrope_sections"] = (8, 4, 4)
    return dataclasses.replace(cfg, **changes)
