"""The port's model API.

One parameter module (:class:`LM`) and the reference's entry points:

  * ``init_params(gen, cfg, max_seq=..., device=...)`` — random weights
    from an explicit ``torch.Generator``, on the card by default
  * ``forward(params, cfg, batch, mode=...)`` — logits, the prompt's
    caches in prefill, and MoE's auxiliary loss
  * ``loss_fn(params, cfg, batch)`` — next-token cross-entropy plus the
    auxiliary loss, the training objective
  * ``encode(params, cfg, frames)`` — the encoder of an encoder-decoder
  * ``prefill(params, cfg, batch)`` — last logits + a ``DecodeState``
  * ``decode_step(params, cfg, state, tokens)`` — one token; writes the
    attention caches in place (the reference's serve step donates them)
  * ``params_from_reference(tree, cfg)`` — the reference's parameter
    pytree (numpy leaves) carried into an :class:`LM`, so both packages
    compute the same function

The parameters are trainable; ``prefill`` and ``decode_step`` serve
under ``torch.no_grad``, so serving builds no autograd graph.

Every registered arch runs, and its smoke config: dense GQA
(qwen2-0.5b, qwen1.5-0.5b, phi3-medium-14b), MLA (minicpm3-4b), the
encoder-decoder with cross attention and learned positions
(whisper-large-v3), M-RoPE with the vision stub (qwen2-vl-72b), MoE
(granite-moe-1b-a400m, moonshot-v1-16b-a3b), RWKV-6 (rwkv6-3b) and
Griffin's RG-LRU with sliding-window attention (recurrentgemma-2b).
The modality frontends are stubs, as in the reference: whisper
consumes precomputed frame embeddings (B, encoder_seq, D), qwen2-vl
precomputed patch embeddings over the first n_vis slots.

The logits cover every row of ``cfg.padded_vocab()``, and the padding
rows of the embedding are random like the rest, as in the reference;
so the sampler can emit an id >= ``cfg.vocab_size``.

Over model ranks (``layers.use_mesh`` with a model axis that spans
ranks) the vocabulary is split as the partition rules put ``embed``
(``(model, data)``) and ``w_lm`` (``(data, model)``): each rank looks
up its row block of the embedding (the sum over the ranks is the
lookup), scores its block of the vocabulary (``logits_fn``,
``forward``, ``prefill`` and ``decode_step`` return that block), and
``loss_fn`` is a vocabulary-parallel cross-entropy.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mesh as C
from repro_torch.core.mesh import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.rope import sinusoidal_embedding
from repro_torch.runtime.spans import span

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16, "float64": torch.float64}


def _dt(cfg: ModelConfig):
    return DTYPES[cfg.param_dtype]


class Encoder(nn.Module):
    """An encoder-decoder's encoder: ``layers`` (one
    :class:`~transformer.Block` a layer) and its ``norm_f``."""

    def __init__(self, layers: List[T.Block], norm_f: dict):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm_f = L.param_dict(norm_f)


class LM(nn.Module):
    """The parameters of an LM: ``embed`` (V_pad, D), ``norm_f``,
    ``layers`` (one :class:`~transformer.Block` a decoder layer),
    untied ``w_lm`` (D, V_pad), learned ``pos_embed`` (max_seq, D) and
    an encoder-decoder's ``enc`` (:class:`Encoder`); each None where the
    config has none."""

    def __init__(self, embed: torch.Tensor, norm_f: dict,
                 layers: List[T.Block], w_lm=None, pos_embed=None,
                 enc: Optional[Encoder] = None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.norm_f = L.param_dict(norm_f)
        self.layers = nn.ModuleList(layers)
        self.w_lm = None if w_lm is None else nn.Parameter(w_lm)
        self.pos_embed = (None if pos_embed is None
                          else nn.Parameter(pos_embed))
        self.enc = enc


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                max_seq: int = 4096, device=None) -> LM:
    """Random weights drawn from ``gen`` on ``device`` (the card unless
    the caller names another; ``gen`` must be a generator of that
    device).  ``max_seq`` sizes a learned position table."""
    device = resolve_device(device, "init_params")
    if gen.device.type != device.type:
        raise ValueError(f"init_params: a {gen.device} generator for "
                         f"{device} weights")
    dtype = _dt(cfg)
    d, v = cfg.d_model, cfg.padded_vocab()
    embed = L.embed_init(gen, v, d, dtype)
    layers = [T.block_init(gen, cfg, kind, dtype, cfg.is_encoder_decoder)
              for kind in cfg.layer_kinds()]
    w_lm = None if cfg.tie_embeddings else L.dense_init(gen, d, v, dtype)
    pos_embed = None
    if cfg.pos_kind == "learned":
        pos_embed = (torch.randn((max_seq, d), generator=gen,
                                 dtype=torch.float32, device=gen.device)
                     * 0.01).to(dtype)
    enc = None
    if cfg.is_encoder_decoder:
        enc = Encoder([T.block_init(gen, cfg, "attn", dtype)
                       for _ in range(cfg.n_encoder_layers)],
                      L.norm_init(d, cfg.norm, dtype, gen.device))
    return LM(embed, L.norm_init(d, cfg.norm, dtype, gen.device), layers,
              w_lm, pos_embed, enc)


def _stack_from_reference(stack: dict, pattern: tuple, conv) -> list:
    """The blocks of a reference stack (``groups[slot]`` leaves stacked
    over the layer groups, ``rem`` a list): layer ``g * len(pattern) +
    slot`` is group g of slot ``slot``; the remainder layers follow."""
    def index(t, g):
        return ({k: index(v, g) for k, v in t.items()}
                if isinstance(t, dict) else t[g])

    slots = [conv(g) for g in stack["groups"]]
    n_groups = (next(iter(slots[0]["norm1"].values())).shape[0]
                if slots and slots[0] else 0)
    layers = [T.Block(kind, index(slots[slot], g))
              for g in range(n_groups)
              for slot, kind in enumerate(pattern)]
    for r, rem in enumerate(stack.get("rem", [])):
        layers.append(T.Block(pattern[r % len(pattern)], conv(rem)))
    return layers


def params_from_reference(tree: dict, cfg: ModelConfig, *,
                          device=None) -> LM:
    """The reference's ``init_params`` pytree, its leaves as numpy
    arrays, as an :class:`LM` on ``device`` (the card unless the caller
    names another): ``dec`` and ``enc.stack`` as blocks, ``embed``,
    ``norm_f``, ``w_lm``, ``pos_embed`` and ``enc.norm_f`` as they are
    (an empty ``rem`` list may be missing)."""
    device = resolve_device(device, "params_from_reference")

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x)).to(device)

    layers = _stack_from_reference(tree["dec"], cfg.mixer_pattern, conv)
    if len(layers) != cfg.n_layers:
        raise ValueError(f"the tree holds {len(layers)} layers, "
                         f"{cfg.name} has {cfg.n_layers}")
    enc = None
    if cfg.is_encoder_decoder:
        enc_layers = _stack_from_reference(tree["enc"]["stack"], ("attn",),
                                           conv)
        if len(enc_layers) != cfg.n_encoder_layers:
            raise ValueError(f"the tree holds {len(enc_layers)} encoder "
                             f"layers, {cfg.name} has "
                             f"{cfg.n_encoder_layers}")
        enc = Encoder(enc_layers, conv(tree["enc"]["norm_f"]))
    return LM(conv(tree["embed"]), conv(tree["norm_f"]), layers,
              None if cfg.tie_embeddings else conv(tree["w_lm"]),
              conv(tree["pos_embed"]) if cfg.pos_kind == "learned" else None,
              enc)


# --------------------------------------------------------------------------
# embeddings / positions / logits
# --------------------------------------------------------------------------

def make_positions(cfg: ModelConfig, batch: int, seq: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    """(B, S) int32 positions ``offset, offset + 1, ...``, or (3, B, S)
    M-RoPE streams (text: all three equal)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None] + offset
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, batch, seq)
    return pos


def vocab_split(cfg: ModelConfig):
    """(the model axis the vocabulary is split over, or None; the first
    row of this rank's block; its rows)."""
    v = cfg.padded_vocab()
    ax = L.split_axis("top", "embed", cfg, v)
    if ax is None:
        return None, 0, v
    part = v // ax.ranks
    return ax, ax.index * part, part


def embed_tokens(params: LM, cfg: ModelConfig, tokens, *,
                 vision_embeds=None, pos_offset: int = 0) -> torch.Tensor:
    """tokens: (B, S) int32 -> (B, S, D), rows of the embedding.  The
    VLM stub's ``vision_embeds`` (B, n_vis, D) overwrite the first n_vis
    slots (all S of them, the tokens unused, where n_vis >= S); learned
    positions add ``pos_embed[pos_offset:pos_offset + S]``, and an
    offset past the table raises (the reference's slice would clamp).
    Over model ranks each rank looks up the tokens of its row block,
    the others' rows zero, and the ranks' lookups are summed."""
    s = tokens.shape[1]
    if vision_embeds is not None and vision_embeds.shape[1] >= s:
        x = vision_embeds[:, :s].to(params.embed.dtype)
    else:
        ax, lo, part = vocab_split(cfg)
        if ax is None:
            x = torch.nn.functional.embedding(tokens, params.embed)
        else:
            local = tokens.long() - lo
            mine = (local >= 0) & (local < part)
            x = torch.nn.functional.embedding(torch.where(mine, local, 0),
                                              params.embed)
            x = C.reduce_from_model(torch.where(mine[..., None], x, 0), ax)
        if vision_embeds is not None:
            x = torch.cat([vision_embeds.to(x.dtype),
                           x[:, vision_embeds.shape[1]:]], dim=1)
    if cfg.pos_kind == "learned":
        if not 0 <= pos_offset <= params.pos_embed.shape[0] - s:
            raise IndexError(f"positions {pos_offset}..{pos_offset + s - 1} "
                             f"outside a position table of "
                             f"{params.pos_embed.shape[0]}")
        x = x + params.pos_embed[pos_offset:pos_offset + s].to(x.dtype)
    return x


def logits_fn(params: LM, cfg: ModelConfig, x) -> torch.Tensor:
    """Final norm + LM head over the padded vocabulary: over model ranks,
    this rank's block of it (``embed``'s row block transposed where the
    embeddings are tied)."""
    h = L.apply_norm(params.norm_f, x, cfg.norm)
    h = C.copy_to_model(h, vocab_split(cfg)[0])
    w = params.embed.t() if cfg.tie_embeddings else params.w_lm
    return h @ w.to(h.dtype)


def argmax_vocab(logits, cfg: ModelConfig) -> torch.Tensor:
    """The id of each row's largest logit, the lowest on ties
    (``argmax``), int64 of ``logits``' leading shape; over model ranks
    from this rank's vocabulary block: each rank's largest and its
    global id gathered, the largest of them taken (the lowest rank on
    ties, hence the lowest id)."""
    ax, lo, _ = vocab_split(cfg)
    if ax is None:
        return torch.argmax(logits, dim=-1)
    v, i = torch.max(logits, dim=-1)
    vs = C.gather_dim(v[..., None].contiguous(), ax, -1)
    ids = C.gather_dim((i + lo)[..., None].contiguous(), ax, -1)
    return torch.take_along_dim(ids, torch.argmax(vs, dim=-1)[..., None],
                                dim=-1)[..., 0]


# --------------------------------------------------------------------------
# encoder (whisper's stub frontend: precomputed frame embeddings)
# --------------------------------------------------------------------------

def encode(params: LM, cfg: ModelConfig, frames, *, q_block: int = 1024,
           kv_block: int = 1024) -> torch.Tensor:
    """frames: (B, enc_seq, D) precomputed embeddings, cast to the
    param dtype, plus the sinusoidal table, through the encoder stack
    (not causal, no cache) and its ``norm_f`` -> (B, enc_seq, D)."""
    b, s, d = frames.shape
    x = frames.to(_dt(cfg))
    x = x + sinusoidal_embedding(s, d, x.dtype, device=x.device)[None]
    pos = torch.arange(s, dtype=torch.int32,
                       device=x.device)[None].expand(b, s)
    x, _, _ = T.stack_apply(params.enc.layers, cfg, x, mode="encode",
                            positions=pos, q_block=q_block,
                            kv_block=kv_block)
    return L.apply_norm(params.enc.norm_f, x, cfg.norm)


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------

def forward(params: LM, cfg: ModelConfig, batch: dict, *,
            mode: str = "train", remat: str = "none", q_block: int = 1024,
            kv_block: int = 1024):
    """batch keys: tokens (B, S) int32; frames (B, enc_seq, D) for an
    encoder-decoder; optional vision_embeds (B, n_vis, D) and positions
    ((B, S), or (3, B, S) under M-RoPE).  Returns (logits (B, S, V_pad),
    caches, aux): the per-layer caches of the prompt in prefill (with
    the encoder's cross KV), None in train; ``aux`` the decoder's MoE
    auxiliary loss (f32, zero without MoE; the encoder's is dropped, as
    in the reference).  ``remat`` is :func:`transformer.stack_apply`'s."""
    x, caches, aux = _stack_out(params, cfg, batch, mode=mode, remat=remat,
                                q_block=q_block, kv_block=kv_block)
    return logits_fn(params, cfg, x), caches, aux


def _stack_out(params: LM, cfg: ModelConfig, batch: dict, *, mode: str,
               remat: str, q_block: int, kv_block: int):
    """:func:`forward` up to the head: (the stack's output, caches,
    aux); the embedding in the span ``embed``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = make_positions(cfg, b, s, device=tokens.device)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encode(params, cfg, batch["frames"], q_block=q_block,
                         kv_block=kv_block)
    with span("embed"):
        x = embed_tokens(params, cfg, tokens,
                         vision_embeds=batch.get("vision_embeds"))
    return T.stack_apply(params.layers, cfg, x, mode=mode,
                         positions=positions, enc_out=enc_out, remat=remat,
                         q_block=q_block, kv_block=kv_block)


def loss_fn(params: LM, cfg: ModelConfig, batch: dict, *,
            remat: str = "none", q_block: int = 1024, kv_block: int = 1024,
            n_tok=None):
    """Next-token cross-entropy plus MoE's auxiliary loss (over model
    ranks a vocabulary-parallel cross-entropy, ``_vocab_parallel_terms``).
    labels: (B, S) int32, -1 = ignore.  Returns (loss, {"ce", "aux", "n_tok"}),
    f32 scalars.  ``n_tok`` replaces the count of labelled tokens the
    sum is divided by (over ranks: the whole batch's, so that the ranks'
    cross-entropies add up to the whole batch's).

    The logits in f32 (an f64 model keeps f64), ``logsumexp``, and the
    label's logit picked with ``take_along_dim`` on the labels clamped
    to 0, then masked: the reference's (B, S, V) one-hot sums one logit
    and zeros, so the pick is the same value, without a (B, S, V) mask
    (157 MB a step at qwen2-0.5b's 153,600 columns).  The head and the
    cross-entropy are the span ``loss`` (``runtime/spans.py``).
    """
    x, _, aux = _stack_out(params, cfg, batch, mode="train", remat=remat,
                           q_block=q_block, kv_block=kv_block)
    with span("loss"):
        logits = logits_fn(params, cfg, x)
        labels = batch["labels"]
        lse, picked = ce_terms(logits, labels, cfg)
        mask = (labels >= 0).to(lse.dtype)
        if n_tok is None:
            n_tok = torch.clamp_min(mask.sum(), 1.0)
        ce = ((lse - picked) * mask).sum() / n_tok
        loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "n_tok": n_tok}


def ce_terms(logits, labels, cfg: ModelConfig):
    """(logsumexp over the padded vocabulary, the label's logit) of each
    position, in f32 (f64 for an f64 model): ``logits`` (B, S, V_pad),
    over model ranks this rank's block (:func:`_vocab_parallel_terms`);
    ``labels`` (B, S), a label of -1 read as 0 (``loss_fn`` masks it)."""
    lf = L.wide(logits)
    ax, lo, part = vocab_split(cfg)
    if ax is not None:
        return _vocab_parallel_terms(lf, labels, ax, lo, part)
    lse = torch.logsumexp(lf, dim=-1)                            # (B, S)
    picked = torch.take_along_dim(
        lf, labels.clamp_min(0).long()[..., None], dim=-1)[..., 0]
    return lse, picked


def _vocab_parallel_terms(lf, labels, ax, lo: int, part: int):
    """(logsumexp, the label's logit) of the whole vocabulary from this
    rank's block ``lf`` (B, S, V / m) of columns ``[lo, lo + part)``:
    the maximum, the sum of exponentials and the label's logit (picked
    on the rank that holds its column, zero elsewhere) each reduced over
    the model ranks (``core/mesh.py``); the padding columns stay in the
    sum.  No rank forms the whole logits."""
    m = C.all_reduce(lf.detach().amax(dim=-1), ax, op="max")
    sumexp = C.reduce_from_model(torch.exp(lf - m[..., None]).sum(dim=-1),
                                 ax)
    lse = m + torch.log(sumexp)
    local = labels.clamp_min(0).long() - lo
    mine = (local >= 0) & (local < part)
    got = torch.take_along_dim(lf, torch.where(mine, local, 0)[..., None],
                               dim=-1)[..., 0]
    picked = C.reduce_from_model(torch.where(mine, got, 0), ax)
    return lse, picked


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """``caches``: one dict a layer (``transformer.init_block_cache``):
    ``{"self": KVCache | MLACache | WindowKVCache}`` and, in an
    encoder-decoder, ``"cross": KVCache``; ``{"state", "xp_t", "xp_c"}``
    for RWKV, ``{"h", "conv"}`` for the RG-LRU; ``pos``: the next write
    position; ``seq_split``: ``{cache key: the whole length of its
    sequence dim}`` of the caches (``"self"``, ``"cross"``) that hold
    this rank's block of their sequence, laid out over the model ranks
    by ``optim/sharding.py::cache_seq_block`` (empty: every cache holds
    its whole sequence; never mutated)."""
    caches: list
    pos: int
    seq_split: dict = {}


def init_decode_state(cfg: ModelConfig, *, batch: int, s_max: int,
                      cache_dtype=torch.bfloat16,
                      device=None) -> DecodeState:
    """Zero caches for ``batch`` rows and ``s_max`` positions, laid out
    over the current mesh's model ranks (``layers.use_mesh``;
    ``transformer.init_block_cache``)."""
    device = resolve_device(device, "init_decode_state")
    return DecodeState(T.stack_caches(cfg, batch=batch, s_max=s_max,
                                      dtype=cache_dtype, device=device), 0,
                       T.seq_split(cfg, s_max))


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, batch: dict, *,
            q_block: int = 1024, kv_block: int = 1024):
    """Run the prompt through the stack, building caches that cover
    exactly the prompt (``launch.serve.state_from_prefill`` pads them).
    Returns (logits_last (B, V_pad), DecodeState)."""
    logits, caches, _ = forward(params, cfg, batch, mode="prefill",
                                q_block=q_block, kv_block=kv_block)
    return logits[:, -1], DecodeState(caches, int(batch["tokens"].shape[1]))


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, state: DecodeState, tokens):
    """One decode step.  tokens: (B, 1) int32.  Writes each attention
    cache at ``state.pos`` (a window cache at ``pos % W``) in place (the
    cross caches are read only), replaces the recurrent states, and
    returns (logits (B, 1, V_pad), the state at ``pos + 1``)."""
    b = tokens.shape[0]
    positions = make_positions(cfg, b, 1, offset=state.pos,
                               device=tokens.device)
    x = embed_tokens(params, cfg, tokens, pos_offset=state.pos)
    x, caches, _ = T.stack_apply(params.layers, cfg, x, mode="decode",
                                 positions=positions, caches=state.caches,
                                 cache_pos=state.pos,
                                 seq_split=state.seq_split)
    return logits_fn(params, cfg, x), DecodeState(caches, state.pos + 1,
                                                  state.seq_split)


def count_params(params: LM) -> int:
    return sum(p.numel() for p in params.parameters())
