"""GQA attention of the port: train, prefill and decode, on one blocked
online-softmax core (``flash_attention``) as in the reference.

Shapes follow (B, S, H, Dh); a layer's KV cache is (B, S_max, H_kv, Dh).

The reference's ``flash_attention`` is plain ``jnp`` (a scan over kv
blocks), not Pallas; the port keeps its numerics: scores in f32, per kv
block the running max, the rescale of the sums and the accumulator, and
the zeroing of a fully masked block, in the same order.  A library
attention (``scaled_dot_product_attention``) computes another rounding
and is not used here.

Decode writes the caches IN PLACE (``cache[:, pos] = new``): the same
bits as the reference's select against an iota, which returns a new
cache that its serve step donates.  MLA, the window ring-buffer cache
(``gqa_decode_window``) and cross attention wait for later slices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import dense_init
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# --------------------------------------------------------------------------
# blocked online-softmax attention core
# --------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset=0, kv_valid_len=None,
                    q_block: int = 1024, kv_block: int = 1024):
    """Blocked attention with online softmax (grouped-query aware).

    q: (B, Sq, Hq, Dq); k: (B, Sk, Hkv, Dq); v: (B, Sk, Hkv, Dv);
    Hq must be a multiple of Hkv.  ``q_offset`` is the absolute position
    of q[0], for the causal and window masks in decode.
    ``kv_valid_len``: mask out k positions >= this (decode caches).
    The sequences are zero-padded to whole blocks.

    Returns (B, Sq, Hq, Dv) in q.dtype.
    """
    b, sq, hq, dq = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    scale = dq ** -0.5
    dev = q.device

    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    sq_p = _cdiv(sq, q_block) * q_block
    sk_p = _cdiv(sk, kv_block) * kv_block
    if sq_p != sq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
    if sk_p != sk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, sk_p - sk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, sk_p - sk))
    if kv_valid_len is None:
        kv_valid_len = sk
    nq, nk = sq_p // q_block, sk_p // kv_block

    # (B, S, H, D) -> (nq, B, Hkv, G, q_block, D)
    qb = q.reshape(b, nq, q_block, hkv, g, dq).permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(b, nk, kv_block, hkv, dq).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nk, kv_block, hkv, dv).permute(1, 0, 3, 2, 4)

    outs = []
    for qi in range(nq):
        q_pos = (q_offset + qi * q_block
                 + torch.arange(q_block, device=dev))
        qf = qb[qi].float()                      # (B, Hkv, G, Bq, Dq)
        m = torch.full((b, hkv, g, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        lse = torch.zeros((b, hkv, g, q_block), dtype=torch.float32,
                          device=dev)
        acc = torch.zeros((b, hkv, g, q_block, dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            k_pos = ki * kv_block + torch.arange(kv_block, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qf,
                             kb[ki].float()) * scale
            mask = k_pos[None, :] < kv_valid_len
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if window:
                mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
            s = torch.where(mask, s, NEG_INF)
            new_m = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - new_m[..., None])
            # fully masked blocks: s == new_m == NEG_INF -> exp(0); zero
            # them
            p = p * mask
            corr = torch.exp(m - new_m)
            lse = lse * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vb[ki].float())
            m = new_m
        outs.append(acc / torch.clamp_min(lse, 1e-30)[..., None])

    out = torch.stack(outs)                      # (nq, B, Hkv, G, Bq, Dv)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq_p, hq, dv)
    return out[:, :sq].to(q.dtype)


# --------------------------------------------------------------------------
# GQA attention (MHA, MQA, local window)
# --------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg, dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {"w_q": dense_init(gen, d, nq * hd, dtype),
         "w_k": dense_init(gen, d, nkv * hd, dtype),
         "w_v": dense_init(gen, d, nkv * hd, dtype),
         "w_o": dense_init(gen, nq * hd, d, dtype,
                           scale=(nq * hd) ** -0.5)}
    if cfg.qkv_bias:
        for name, n in (("b_q", nq), ("b_k", nkv), ("b_v", nkv)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=gen.device)
    return p


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, H_kv, Dh)
    v: torch.Tensor


def _qkv(params, x, cfg, positions):
    """The rotated q (B, S, Hq, Dh) and k, v (B, S, Hkv, Dh) of ``x``."""
    b, s, _ = x.shape
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = x @ params["w_q"]
    k = x @ params["w_k"]
    v = x @ params["w_v"]
    if "b_q" in params:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    q = q.reshape(b, s, nq, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if cfg.pos_kind == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(params, x, cfg, *, positions, mode: str,
                  cache: Optional[KVCache] = None, cache_pos=None,
                  window: int = 0, q_block: int = 1024,
                  kv_block: int = 1024):
    """GQA attention for train / prefill / decode.

    x: (B, S, D); positions: (B, S).  decode mode: S == 1, ``cache``
    holds S_max slots and ``cache_pos`` (an int) is the write position;
    the cache is written in place.  Returns (y, new_cache): the prompt's
    KVCache in prefill, the written cache in decode, None in train.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    new_cache = None
    if mode == "decode":
        if cache is None:
            raise ValueError("gqa_attention: decode needs a cache")
        ck = _masked_cache_write(cache.k, k, cache_pos)
        cv = _masked_cache_write(cache.v, v, cache_pos)
        new_cache = KVCache(ck, cv)
        k, v = ck, cv
        q_offset, kv_valid, causal = cache_pos, cache_pos + 1, False
    else:
        q_offset, kv_valid, causal = 0, None, mode != "encode"
        if mode == "prefill":
            new_cache = KVCache(k, v)
    y = flash_attention(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, kv_valid_len=kv_valid,
                        q_block=q_block, kv_block=kv_block)
    y = y.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim)
    return y @ params["w_o"], new_cache


# --------------------------------------------------------------------------
# decode path (Sq == 1): plain masked attention over the cache
# --------------------------------------------------------------------------

def _plain_decode_attn(q, k, v, mask):
    """q: (B,1,Hq,D); k/v: (B,S,Hkv,D); mask: (B,1,1,S) or (1,1,1,S).

    Products in the cache dtype widened to f32 and f32 sums (the
    reference's ``preferred_element_type=f32``; a product of two bf16
    values is exact in f32).
    """
    b, _, hq, dq = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, 1, hkv, g, dq).to(k.dtype)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(),
                     k.float()) * dq ** -0.5
    s = torch.where(mask[:, :, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, 1, hq, -1).to(q.dtype)


def _masked_cache_write(cache_arr, new, cache_pos: int, seq_axis: int = 1):
    """Write ``new`` (a length-1 sequence) at ``cache_pos`` of
    ``cache_arr`` IN PLACE, cast to the cache's dtype, and return the
    cache.  A position past the cache raises (the reference's select
    would write nothing)."""
    idx = [slice(None)] * cache_arr.dim()
    idx[seq_axis] = slice(cache_pos, cache_pos + 1)
    if not 0 <= cache_pos < cache_arr.shape[seq_axis]:
        raise IndexError(f"cache position {cache_pos} outside a cache of "
                         f"{cache_arr.shape[seq_axis]}")
    cache_arr[tuple(idx)] = new.to(cache_arr.dtype)
    return cache_arr


def gqa_decode(params, x, cfg, *, cache: KVCache, cache_pos: int,
               positions):
    """Single-token decode against a full-length cache (written in
    place).  Returns (y (B, 1, D), the cache)."""
    b = x.shape[0]
    q, k, v = _qkv(params, x, cfg, positions)
    ck = _masked_cache_write(cache.k, k, cache_pos)
    cv = _masked_cache_write(cache.v, v, cache_pos)
    s_max = ck.shape[1]
    mask = (torch.arange(s_max, device=x.device)
            <= cache_pos)[None, None, None]
    y = _plain_decode_attn(q, ck, cv, mask)
    y = y.reshape(b, 1, cfg.n_heads * cfg.resolved_head_dim)
    return y @ params["w_o"], KVCache(ck, cv)
