"""Transformer blocks of the port and the stack over them.

A block is an ``nn.Module`` holding the reference's block pytree as
``nn.ParameterDict``s (``norm1``, ``norm2``, ``mixer``, ``ffn`` and, in
an encoder-decoder's decoder, ``norm_c`` and ``cross``); the stack is
an ``nn.ModuleList`` run layer by layer.  The reference scans over
stacked groups of layers because ``jit`` wants one traced body; eager
PyTorch has no such need, so the layers are unrolled and a layer's
cache is its own ``{"self": KVCache | MLACache, "cross": KVCache}``.
This slice runs ``kind == "attn"`` blocks (GQA or MLA) with a dense
FFN; ``models.model.check_ported`` refuses the rest.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L


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
    if kind != "attn":
        raise NotImplementedError(f"a {kind!r} block is not ported")
    parts = {"norm1": L.norm_init(d, cfg.norm, dtype, dev),
             "norm2": L.norm_init(d, cfg.norm, dtype, dev),
             "mixer": (attn.mla_init(gen, cfg, dtype)
                       if cfg.attn_kind == "mla"
                       else attn.gqa_init(gen, cfg, dtype))}
    if with_cross:
        parts["norm_c"] = L.norm_init(d, cfg.norm, dtype, dev)
        parts["cross"] = attn.gqa_init(gen, cfg, dtype)
    parts["ffn"] = L.ffn_init(gen, d, cfg.d_ff, cfg.act, dtype)
    return Block(kind, parts)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                     dtype, device, with_cross: bool = False,
                     enc_seq: int = 0) -> dict:
    """Zero caches for decode."""
    if kind != "attn":
        raise NotImplementedError(f"a {kind!r} block's cache is not ported")

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    if cfg.attn_kind == "mla":
        m = cfg.mla
        c = {"self": attn.MLACache(zeros(batch, s_max, m.kv_lora_rank),
                                   zeros(batch, s_max, m.qk_rope_dim))}
    else:
        c = {"self": attn.KVCache(zeros(batch, s_max, nkv, hd),
                                  zeros(batch, s_max, nkv, hd))}
    if with_cross:
        c["cross"] = attn.KVCache(zeros(batch, enc_seq, nkv, hd),
                                  zeros(batch, enc_seq, nkv, hd))
    return c


def block_apply(block: Block, cfg: ModelConfig, x, *, positions, mode: str,
                cache: Optional[dict] = None, cache_pos=None, enc_out=None,
                q_block: int = 1024, kv_block: int = 1024):
    """Apply one block.  Returns (x', cache'): the prompt's caches in
    prefill, the caches written in place in decode, None in train and
    encode."""
    h = L.apply_norm(block.norm1, x, cfg.norm)
    if cfg.attn_kind == "mla":
        y, c = attn.mla_attention(
            block.mixer, h, cfg, positions=positions, mode=mode,
            cache=None if cache is None else cache["self"],
            cache_pos=cache_pos, q_block=q_block, kv_block=kv_block)
    elif mode == "decode":
        y, c = attn.gqa_decode(block.mixer, h, cfg, cache=cache["self"],
                               cache_pos=cache_pos, positions=positions)
    else:
        y, c = attn.gqa_attention(block.mixer, h, cfg, positions=positions,
                                  mode=mode, window=cfg.local_window,
                                  q_block=q_block, kv_block=kv_block)
    x = x + y
    new_cache = None if c is None else {"self": c}

    if block.has_cross:
        hc = L.apply_norm(block.norm_c, x, cfg.norm)
        if mode == "decode":
            yc, cc = attn.cross_decode(block.cross, hc, cfg,
                                       cache=cache["cross"])
        else:
            yc, cc = attn.gqa_attention(block.cross, hc, cfg,
                                        positions=positions, mode=mode,
                                        kv_source=enc_out, q_block=q_block,
                                        kv_block=kv_block)
        if new_cache is not None:
            new_cache["cross"] = cc
        x = x + yc

    h = L.apply_norm(block.norm2, x, cfg.norm)
    x = x + L.apply_ffn(block.ffn, h, cfg.act)
    return x, new_cache


def stack_caches(cfg: ModelConfig, *, batch: int, s_max: int, dtype,
                 device) -> List[dict]:
    return [init_block_cache(cfg, kind, batch, s_max, dtype, device,
                             cfg.is_encoder_decoder, cfg.encoder_seq)
            for kind in cfg.layer_kinds()]


def stack_apply(layers: nn.ModuleList, cfg: ModelConfig, x, *, mode: str,
                positions, caches=None, cache_pos=None, enc_out=None,
                q_block: int = 1024, kv_block: int = 1024):
    """Run the stack.  Returns (x, caches'): a list of per-layer caches
    in prefill and decode, None in train and encode."""
    new_caches = []
    for i, block in enumerate(layers):
        x, c = block_apply(block, cfg, x, positions=positions, mode=mode,
                           cache=None if caches is None else caches[i],
                           cache_pos=cache_pos, enc_out=enc_out,
                           q_block=q_block, kv_block=kv_block)
        new_caches.append(c)
    return x, (new_caches if mode in ("prefill", "decode") else None)
