"""Operations and bytes that a cell's work needs, counted from the
configuration and the shapes alone, never from what the program
launches: a program that fuses or drops kernels leaves these numbers as
they are."""
from __future__ import annotations


def topk_bytes(queries: int, peers: int, items_per_peer: int,
               k: int) -> int:
    """Least bytes of the per-peer top-k of ``queries`` stacked queries:
    every f32 score read once, each peer's (k,) f32 values and int32
    indices written once."""
    return queries * peers * (items_per_peer * 4 + k * 8)


def fd_call_bytes(queries: int, n_items: int, k: int) -> int:
    """Least bytes of one stacked top-k call, whatever implements it:
    every f32 score read once, each query's k f32 values and int32
    indices written once."""
    return queries * (n_items * 4 + k * 8)


def active_matmul_params(c: dict) -> int:
    """Parameters a token multiplies with in a MoE decoder of the
    Hugging Face keys in ``c``: the attention projections, the router,
    ``num_experts_per_tok`` experts (SwiGLU, three matrices) and the
    output head over the published vocabulary.  The embedding lookup and
    the norms do no products."""
    d, h, kv = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"]
    hd = d // h
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    moe = d * c["num_local_experts"] + \
        c["num_experts_per_tok"] * 3 * d * c["intermediate_size"]
    return c["num_hidden_layers"] * (attn + moe) + d * c["vocab_size"]


def train_flops_per_token(c: dict, seq: int) -> float:
    """Model FLOPs of one trained token at sequence length ``seq``: 6 a
    multiplied parameter (forward 2, backward 4), plus causal
    attention's two products over the (seq + 1) / 2 keys a query sees on
    average, 2 * 2 * heads * head size a key forward, times 3 with the
    backward.  Recomputation is not counted: it is the program's choice,
    not the model's work."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    hd = d // h
    attn = 12 * c["num_hidden_layers"] * h * hd * (seq + 1) / 2
    return 6 * active_matmul_params(c) + attn
