"""The port's model API for the dense GQA architectures.

One parameter module (:class:`LM`) and the reference's entry points:

  * ``init_params(gen, cfg, max_seq=..., device=...)`` — random weights
    from an explicit ``torch.Generator``, on the card by default
  * ``forward(params, cfg, batch, mode=...)`` — logits (and the prompt's
    caches in prefill)
  * ``prefill(params, cfg, batch)`` — last logits + a ``DecodeState``
  * ``decode_step(params, cfg, state, tokens)`` — one token; writes the
    caches in place (the reference's serve step donates them)
  * ``params_from_reference(tree, cfg)`` — the reference's parameter
    pytree (numpy leaves) carried into an :class:`LM`, so both packages
    compute the same function

This slice runs the dense GQA configs (qwen2-0.5b, qwen1.5-0.5b,
phi3-medium-14b and their smoke configs); :func:`check_ported` refuses
every other with ``NotImplementedError``, naming what is missing.  The
reference's third output of ``forward`` (MoE's auxiliary loss) and
``loss_fn`` wait for the MoE and training slices.

The logits cover every row of ``cfg.padded_vocab()``, and the padding
rows of the embedding are random like the rest, as in the reference;
so the sampler can emit an id >= ``cfg.vocab_size``.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mesh import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def _dt(cfg: ModelConfig):
    return DTYPES[cfg.param_dtype]


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming ``cfg`` and what of it the
    port lacks, unless it is a dense GQA config this slice runs."""
    missing = []
    if cfg.family != "dense":
        missing.append(f"family {cfg.family!r}")
    if cfg.attn_kind != "gqa":
        missing.append(f"attn_kind {cfg.attn_kind!r}")
    if cfg.moe is not None:
        missing.append("MoE")
    if cfg.recurrent is not None or any(k != "attn"
                                        for k in cfg.mixer_pattern):
        missing.append(f"recurrent mixers {cfg.mixer_pattern}")
    if cfg.local_window:
        missing.append("sliding-window attention")
    if cfg.mrope_sections is not None:
        missing.append("M-RoPE")
    if cfg.is_encoder_decoder:
        missing.append("the encoder-decoder stack")
    if cfg.pos_kind != "rope":
        missing.append(f"pos_kind {cfg.pos_kind!r}")
    if cfg.act not in ("swiglu", "gelu"):
        missing.append(f"act {cfg.act!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch "
            "yet (this slice runs the dense GQA configs)")


class LM(nn.Module):
    """The parameters of a dense decoder LM: ``embed`` (V_pad, D),
    ``norm_f``, ``layers`` (one :class:`~transformer.Block` a layer) and,
    untied, ``w_lm`` (D, V_pad)."""

    def __init__(self, embed: torch.Tensor, norm_f: dict,
                 layers: List[T.Block], w_lm=None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.norm_f = L.param_dict(norm_f)
        self.layers = nn.ModuleList(layers)
        self.w_lm = (None if w_lm is None
                     else nn.Parameter(w_lm, requires_grad=False))


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                max_seq: int = 4096, device=None) -> LM:
    """Random weights drawn from ``gen`` on ``device`` (the card unless
    the caller names another; ``gen`` must be a generator of that
    device).  ``max_seq`` sizes a learned position table, which this
    slice does not port."""
    check_ported(cfg)
    device = resolve_device(device, "init_params")
    if gen.device.type != device.type:
        raise ValueError(f"init_params: a {gen.device} generator for "
                         f"{device} weights")
    dtype = _dt(cfg)
    d, v = cfg.d_model, cfg.padded_vocab()
    embed = L.embed_init(gen, v, d, dtype)
    layers = [T.block_init(gen, cfg, kind, dtype)
              for kind in cfg.layer_kinds()]
    w_lm = None if cfg.tie_embeddings else L.dense_init(gen, d, v, dtype)
    return LM(embed, L.norm_init(d, cfg.norm, dtype, gen.device), layers,
              w_lm)


def params_from_reference(tree: dict, cfg: ModelConfig, *,
                          device=None) -> LM:
    """The reference's ``init_params`` pytree, its leaves as numpy
    arrays (``dec.groups[slot]`` leaves stacked over the layer groups,
    ``dec.rem`` a list), as an :class:`LM` on ``device`` (the card
    unless the caller names another).  Layer ``g * len(pattern) + slot``
    is group g of slot ``slot``; the remainder layers follow."""
    check_ported(cfg)
    device = resolve_device(device, "params_from_reference")

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x)).to(device)

    dec = tree["dec"]
    pattern = cfg.mixer_pattern
    slots = [conv(g) for g in dec["groups"]]
    n_groups = (next(iter(slots[0]["norm1"].values())).shape[0]
                if slots and slots[0] else 0)
    layers = []
    for g in range(n_groups):
        for slot, kind in enumerate(pattern):
            layers.append(T.Block(kind, {
                part: {k: t[g] for k, t in ts.items()}
                for part, ts in slots[slot].items()}))
    for r, rem in enumerate(dec["rem"]):
        layers.append(T.Block(pattern[r % len(pattern)], conv(rem)))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"the tree holds {len(layers)} layers, "
                         f"{cfg.name} has {cfg.n_layers}")
    return LM(conv(tree["embed"]), conv(tree["norm_f"]), layers,
              None if cfg.tie_embeddings else conv(tree["w_lm"]))


# --------------------------------------------------------------------------
# embeddings / positions / logits
# --------------------------------------------------------------------------

def make_positions(cfg: ModelConfig, batch: int, seq: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    """(B, S) int32 positions ``offset, offset + 1, ...``."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None] + offset
    return pos.expand(batch, seq)


def embed_tokens(params: LM, cfg: ModelConfig, tokens) -> torch.Tensor:
    """tokens: (B, S) int32 -> (B, S, D), rows of the embedding."""
    return torch.nn.functional.embedding(tokens, params.embed)


def logits_fn(params: LM, cfg: ModelConfig, x) -> torch.Tensor:
    """Final norm + LM head over the padded vocabulary."""
    h = L.apply_norm(params.norm_f, x, cfg.norm)
    w = params.embed.t() if cfg.tie_embeddings else params.w_lm
    return h @ w.to(h.dtype)


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------

def forward(params: LM, cfg: ModelConfig, batch: dict, *,
            mode: str = "train", q_block: int = 1024,
            kv_block: int = 1024):
    """batch keys: tokens (B, S) int32; optional positions (B, S).
    Returns (logits (B, S, V_pad), caches): the per-layer caches of the
    prompt in prefill, None in train."""
    check_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = make_positions(cfg, b, s, device=tokens.device)
    x = embed_tokens(params, cfg, tokens)
    x, caches = T.stack_apply(params.layers, cfg, x, mode=mode,
                              positions=positions, q_block=q_block,
                              kv_block=kv_block)
    return logits_fn(params, cfg, x), caches


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

class DecodeState(NamedTuple):
    caches: list          # one {"self": KVCache} a layer
    pos: int              # the next write position


def init_decode_state(cfg: ModelConfig, *, batch: int, s_max: int,
                      cache_dtype=torch.bfloat16,
                      device=None) -> DecodeState:
    check_ported(cfg)
    device = resolve_device(device, "init_decode_state")
    return DecodeState(T.stack_caches(cfg, batch=batch, s_max=s_max,
                                      dtype=cache_dtype, device=device), 0)


def prefill(params: LM, cfg: ModelConfig, batch: dict, *,
            q_block: int = 1024, kv_block: int = 1024):
    """Run the prompt through the stack, building caches that cover
    exactly the prompt (``launch.serve.state_from_prefill`` pads them).
    Returns (logits_last (B, V_pad), DecodeState)."""
    logits, caches = forward(params, cfg, batch, mode="prefill",
                             q_block=q_block, kv_block=kv_block)
    return logits[:, -1], DecodeState(caches, int(batch["tokens"].shape[1]))


def decode_step(params: LM, cfg: ModelConfig, state: DecodeState, tokens):
    """One decode step.  tokens: (B, 1) int32.  Writes each layer's
    cache at ``state.pos`` in place and returns (logits (B, 1, V_pad),
    the state at ``pos + 1``)."""
    b = tokens.shape[0]
    positions = make_positions(cfg, b, 1, offset=state.pos,
                               device=tokens.device)
    x = embed_tokens(params, cfg, tokens)
    x, caches = T.stack_apply(params.layers, cfg, x, mode="decode",
                              positions=positions, caches=state.caches,
                              cache_pos=state.pos)
    return logits_fn(params, cfg, x), DecodeState(caches, state.pos + 1)


def count_params(params: LM) -> int:
    return sum(p.numel() for p in params.parameters())
