"""Transformer blocks of the port and the stack over them.

A block is an ``nn.Module`` holding the reference's block pytree as
``nn.ParameterDict``s (``norm1``, ``norm2``, ``mixer``, ``ffn`` and, in
an encoder-decoder's decoder, ``norm_c`` and ``cross``); the stack is
an ``nn.ModuleList`` run layer by layer.  The reference scans over
stacked groups of layers because ``jit`` wants one traced body; eager
PyTorch has no such need, so the layers are unrolled and a layer's
cache is its own dict: ``{"self": KVCache | MLACache | WindowKVCache,
"cross": KVCache}`` for attention, ``{"state", "xp_t", "xp_c"}`` for
RWKV (``xp_c`` the channel mix's carry), ``{"h", "conv"}`` for Griffin's
RG-LRU.  The mixer is GQA or MLA attention (``kind == "attn"``, with a
sliding window where ``cfg.local_window`` is set), RWKV-6 (``"rwkv"``)
or the RG-LRU (``"rglru"``); the FFN is dense, MoE or the RWKV channel
mix.  Spans (``runtime/spans.py``): ``block`` (``layer=i``) around each
layer, ``attention`` around its attention (and cross attention), ``moe``
around its MoE FFN; remat's replay opens them again in the backward.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import griffin, rwkv
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.runtime.spans import span


class Block(nn.Module):
    """One layer: its parameters as the reference's block pytree,
    ``parts = {"norm1": {...}, "norm2": {...}, "mixer": {...},
    "ffn": {...}}`` of tensors (MLA's mixer nests ``q_norm`` and
    ``kv_norm``), plus ``"norm_c"`` and ``"cross"`` where the layer
    cross-attends to an encoder."""

    def __init__(self, kind: str, parts: dict):
        super().__init__()
        self.kind = kind
        self.has_cross = "cross" in parts
        for name, tensors in parts.items():
            setattr(self, name, L.param_dict(tensors))


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype,
               with_cross: bool = False) -> Block:
    d, dev = cfg.d_model, gen.device
    parts = {"norm1": L.norm_init(d, cfg.norm, dtype, dev),
             "norm2": L.norm_init(d, cfg.norm, dtype, dev)}
    if kind == "attn":
        parts["mixer"] = (attn.mla_init(gen, cfg, dtype)
                          if cfg.attn_kind == "mla"
                          else attn.gqa_init(gen, cfg, dtype))
    elif kind == "rwkv":
        parts["mixer"] = rwkv.rwkv_init(gen, cfg, dtype)
    elif kind == "rglru":
        parts["mixer"] = griffin.griffin_init(gen, cfg, dtype)
    else:
        raise ValueError(f"unknown mixer kind {kind!r}")
    if with_cross:
        parts["norm_c"] = L.norm_init(d, cfg.norm, dtype, dev)
        parts["cross"] = attn.gqa_init(gen, cfg, dtype)
    if cfg.moe is not None:
        parts["ffn"] = moe_mod.moe_init(gen, cfg, dtype)
    elif cfg.act == "rwkv_channel_mix":
        parts["ffn"] = L.rwkv_cmix_init(gen, d, cfg.d_ff, dtype)
    else:
        parts["ffn"] = L.ffn_init(gen, d, cfg.d_ff, cfg.act, dtype)
    return Block(kind, parts)


def seq_split(cfg: ModelConfig, s_max: int) -> dict:
    """``{cache key: the whole length of its sequence dim}`` of the
    attention caches of :func:`init_block_cache` (``"self"``: S_max, or
    a window's min(W, S_max) slots; ``"cross"``: the encoder's frames)
    that the current mesh cuts over the model ranks
    (``layers.seq_block``): ``DecodeState.seq_split``."""
    lengths = {}
    if "attn" in cfg.layer_kinds():
        lengths["self"] = (min(cfg.local_window, s_max) if cfg.local_window
                           else s_max)
    if cfg.is_encoder_decoder:
        lengths["cross"] = cfg.encoder_seq
    return {k: n for k, n in lengths.items() if L.seq_block(n) is not None}


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                     dtype, device, with_cross: bool = False,
                     enc_seq: int = 0) -> dict:
    """Zero caches for decode; the recurrent states in f32, a window
    cache of min(window, s_max) empty slots.  Over model ranks (the
    current mesh, ``layers.use_mesh``) they hold this rank's RG-LRU
    width, and each attention cache this rank's block of its sequence
    dim for every KV head where ``layers.seq_block`` cuts it, else
    this rank's KV heads over the whole sequence."""
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def seq(n):
        """(this rank's length of a sequence dim of n, its KV heads)"""
        block = L.seq_block(n)
        if block is None:
            return n, attn.head_split(cfg).nk
        return block[2], cfg.n_kv_heads

    f32 = torch.float32
    hd = cfg.resolved_head_dim
    if kind == "attn":
        if cfg.attn_kind == "mla":
            m = cfg.mla
            n, _ = seq(s_max)
            c = {"self": attn.MLACache(zeros(batch, n, m.kv_lora_rank),
                                       zeros(batch, n, m.qk_rope_dim))}
        elif cfg.local_window:
            w, nkv = seq(min(cfg.local_window, s_max))
            c = {"self": attn.WindowKVCache(
                zeros(batch, w, nkv, hd), zeros(batch, w, nkv, hd),
                torch.full((w,), -1, dtype=torch.int32, device=device))}
        else:
            n, nkv = seq(s_max)
            c = {"self": attn.KVCache(zeros(batch, n, nkv, hd),
                                      zeros(batch, n, nkv, hd))}
    elif kind == "rwkv":
        kd = cfg.recurrent.rwkv_head_dim
        h = cfg.d_model // kd
        c = {"state": zeros(batch, h, kd, kd, dt=f32),
             "xp_t": zeros(batch, 1, cfg.d_model, dt=f32),
             "xp_c": zeros(batch, 1, cfg.d_model, dt=f32)}
    elif kind == "rglru":
        _, lw = griffin.width_split(cfg)
        c = {"h": zeros(batch, lw, dt=f32),
             "conv": zeros(batch, cfg.recurrent.conv_width - 1, lw, dt=f32)}
    else:
        raise ValueError(f"unknown mixer kind {kind!r}")
    if with_cross:
        n, nkv = seq(enc_seq)
        c["cross"] = attn.KVCache(zeros(batch, n, nkv, hd),
                                  zeros(batch, n, nkv, hd))
    return c


def _attn_mixer(block: Block, cfg: ModelConfig, h, *, positions, mode,
                cache, cache_pos, q_block, kv_block, seq_len):
    """The attention mixer: (y, its "self" cache or None); ``seq_len``:
    the whole length of the decode cache's sequence where it holds this
    rank's block of it, else None."""
    if cfg.attn_kind == "mla":
        return attn.mla_attention(
            block.mixer, h, cfg, positions=positions, mode=mode,
            cache=None if cache is None else cache["self"],
            cache_pos=cache_pos, q_block=q_block, kv_block=kv_block,
            seq_len=seq_len)
    if mode == "decode":
        decode = (attn.gqa_decode_window if cfg.local_window
                  else attn.gqa_decode)
        return decode(block.mixer, h, cfg, cache=cache["self"],
                      cache_pos=cache_pos, positions=positions,
                      seq_len=seq_len)
    return attn.gqa_attention(block.mixer, h, cfg, positions=positions,
                              mode=mode, window=cfg.local_window,
                              q_block=q_block, kv_block=kv_block)


def block_apply(block: Block, cfg: ModelConfig, x, *, positions, mode: str,
                cache: Optional[dict] = None, cache_pos=None, enc_out=None,
                q_block: int = 1024, kv_block: int = 1024,
                seq_split: Optional[dict] = None):
    """Apply one block.  Returns (x', cache', aux_loss): the prompt's
    caches in prefill (the recurrent ones run from zero states), the
    caches in decode (attention's written in place, the recurrent states
    new tensors), None in train and encode; ``aux_loss`` is MoE's
    load-balance loss (f32), None for any other FFN.  ``seq_split``:
    ``{cache key: whole length}`` of the decode caches that hold this
    rank's block of their sequence (``DecodeState.seq_split``)."""
    seq_split = seq_split or {}
    keep = mode in ("prefill", "decode")
    aux = None
    new_cache = {} if keep else None
    b, dev = x.shape[0], x.device
    h = L.apply_norm(block.norm1, x, cfg.norm)
    if block.kind == "attn":
        with span("attention"):
            y, c = _attn_mixer(block, cfg, h, positions=positions,
                               mode=mode, cache=cache, cache_pos=cache_pos,
                               q_block=q_block, kv_block=kv_block,
                               seq_len=seq_split.get("self"))
        if keep and c is not None:
            new_cache["self"] = c
    elif block.kind == "rwkv":
        st, xp = ((cache["state"], cache["xp_t"]) if cache is not None
                  else rwkv.rwkv_init_state(cfg, b, dev))
        y, (st, xp) = rwkv.apply_rwkv(block.mixer, h, cfg, state=st,
                                      x_prev=xp)
        if keep:
            new_cache["state"], new_cache["xp_t"] = st, xp
    elif block.kind == "rglru":
        st = ((cache["h"], cache["conv"]) if cache is not None
              else griffin.griffin_init_state(cfg, b, dev))
        y, st = griffin.apply_griffin(block.mixer, h, cfg, state=st)
        if keep:
            new_cache["h"], new_cache["conv"] = st
    else:
        raise ValueError(f"unknown mixer kind {block.kind!r}")
    x = x + y

    if block.has_cross:
        hc = L.apply_norm(block.norm_c, x, cfg.norm)
        with span("attention"):
            if mode == "decode":
                yc, cc = attn.cross_decode(block.cross, hc, cfg,
                                           cache=cache["cross"],
                                           seq_len=seq_split.get("cross"))
            else:
                yc, cc = attn.gqa_attention(
                    block.cross, hc, cfg, positions=positions, mode=mode,
                    kv_source=enc_out, q_block=q_block, kv_block=kv_block)
        if keep:
            new_cache["cross"] = cc
        x = x + yc

    h = L.apply_norm(block.norm2, x, cfg.norm)
    if cfg.moe is not None:
        with span("moe"):
            y, aux = moe_mod.apply_moe(block.ffn, h, cfg)
    elif cfg.act == "rwkv_channel_mix":
        xp = (cache["xp_c"] if cache is not None
              else torch.zeros((b, 1, cfg.d_model), dtype=torch.float32,
                               device=dev))
        y, xp = L.apply_rwkv_cmix(block.ffn, h, xp, cfg)
        if keep:
            new_cache["xp_c"] = xp
    else:
        y = L.apply_ffn(block.ffn, h, cfg.act, cfg)
    return x + y, new_cache, aux


def stack_caches(cfg: ModelConfig, *, batch: int, s_max: int, dtype,
                 device) -> List[dict]:
    return [init_block_cache(cfg, kind, batch, s_max, dtype, device,
                             cfg.is_encoder_decoder, cfg.encoder_seq)
            for kind in cfg.layer_kinds()]


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``:
    save the outputs of products without batch dims (``x @ w``, which
    dispatches to ``mm`` / ``addmm``) and recompute the rest, the
    batched ``bmm`` of attention and of the experts included."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` under the reference's ``remat`` policy: ``"none"``,
    ``"full"`` (every activation recomputed in the backward) or
    ``"dots"`` (:func:`_dots_policy`).  No value changes."""
    if remat == "none":
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if remat == "dots":
        return lambda *a: checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"unknown remat {remat!r}")


def stack_apply(layers: nn.ModuleList, cfg: ModelConfig, x, *, mode: str,
                positions, caches=None, cache_pos=None, enc_out=None,
                remat: str = "none", q_block: int = 1024,
                kv_block: int = 1024, seq_split: Optional[dict] = None):
    """Run the stack.  Returns (x, caches', aux_sum): a list of
    per-layer caches in prefill and decode, None in train and encode;
    the auxiliary losses summed as the reference sums them (within a
    group, then over the groups, then the remainder layers), an f32 zero
    without MoE, and None in decode, whose callers drop it as the
    reference's do (so a decode step launches nothing for it).

    The reference scans over groups of ``len(cfg.mixer_pattern)`` layers
    and applies the rest one by one; ``remat`` (:func:`_remat`) wraps
    each group as the reference's ``group_body``, never a remainder
    layer.  (The reference groups an encoder by ``("attn",)``; the
    encoder runs without remat and drops its aux, so its grouping
    changes no value.)  ``seq_split`` is :func:`block_apply`'s.
    """
    glen = len(cfg.mixer_pattern)
    n_grouped = len(layers) // glen * glen
    want_aux = mode != "decode"

    def add(total, a):
        if a is None or not want_aux:
            return total
        return a if total is None else total + a

    def run(i, x):
        with span("block", layer=i):
            return block_apply(layers[i], cfg, x, positions=positions,
                               mode=mode,
                               cache=None if caches is None else caches[i],
                               cache_pos=cache_pos, enc_out=enc_out,
                               q_block=q_block, kv_block=kv_block,
                               seq_split=seq_split)

    def group_body(g, x):
        aux, new = None, []
        for i in range(g, g + glen):
            x, c, a = run(i, x)
            aux = add(aux, a)
            new.append(c)
        return x, new, aux

    new_caches, group_aux = [], []
    for g in range(0, n_grouped, glen):
        x, new, aux = _remat(functools.partial(group_body, g), remat)(x)
        new_caches += new
        if aux is not None:
            group_aux.append(aux)
    aux_total = torch.stack(group_aux).sum() if group_aux else None
    for i in range(n_grouped, len(layers)):
        x, c, a = run(i, x)
        aux_total = add(aux_total, a)
        new_caches.append(c)
    if want_aux and aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return (x, new_caches if mode in ("prefill", "decode") else None,
            aux_total)
