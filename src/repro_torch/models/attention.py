"""Attention token mixers of the port: GQA (+QKV bias, M-RoPE), MLA, and
encoder / cross attention, on one blocked online-softmax core
(``flash_attention``) as in the reference.

Shapes follow (B, S, H, Dh); a layer's KV cache is (B, S_max, H_kv, Dh),
an MLA layer's (B, S_max, kv_lora_rank) and (B, S_max, qk_rope_dim), a
cross-attention layer's (B, S_enc, H_kv, Dh) over the encoder's frames.

The reference's ``flash_attention`` is plain ``jnp`` (a scan over kv
blocks), not Pallas; the port keeps its numerics: scores in f32, per kv
block the running max, the rescale of the sums and the accumulator, and
the zeroing of a fully masked block, in the same order.  A library
attention (``scaled_dot_product_attention``) computes another rounding
and is not used here.

Decode writes the caches IN PLACE (``cache[:, pos] = new``): the same
bits as the reference's select against an iota, which returns a new
cache that its serve step donates.  Sliding-window attention
(``local_window``, recurrentgemma-2b's attention layers) decodes
against a ring buffer of W slots (``WindowKVCache``,
``gqa_decode_window``), written in place at ``pos % W``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import apply_norm, dense_init, norm_init
from repro_torch.models.rope import apply_mrope, apply_rope

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
# GQA attention (MHA, MQA, local window, M-RoPE, cross attention)
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


def _rotate_qk(q, k, cfg, positions):
    """q and k rotated by RoPE, or by M-RoPE over (3, B, S) positions
    where ``cfg.mrope_sections`` is set; unrotated unless
    ``cfg.pos_kind == "rope"``."""
    if cfg.pos_kind != "rope":
        return q, k
    if cfg.mrope_sections is not None:
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _proj(params, x, name, heads, hd):
    """``x @ w_<name> (+ b_<name>)`` as (B, S, heads, hd)."""
    y = x @ params[f"w_{name}"]
    if f"b_{name}" in params:
        y = y + params[f"b_{name}"]
    return y.reshape(x.shape[0], x.shape[1], heads, hd)


def _qkv(params, x, cfg, positions):
    """The rotated q (B, S, Hq, Dh) and k, v (B, S, Hkv, Dh) of ``x``."""
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = _proj(params, x, "q", nq, hd)
    k = _proj(params, x, "k", nkv, hd)
    v = _proj(params, x, "v", nkv, hd)
    q, k = _rotate_qk(q, k, cfg, positions)
    return q, k, v


def gqa_attention(params, x, cfg, *, positions, mode: str,
                  cache: Optional[KVCache] = None, cache_pos=None,
                  kv_source=None, window: int = 0, q_block: int = 1024,
                  kv_block: int = 1024):
    """GQA attention for train / prefill / decode / encode, and cross
    attention when ``kv_source`` is given.

    x: (B, S, D); positions: (B, S), or (3, B, S) under M-RoPE.  decode
    mode: S == 1, ``cache`` holds S_max slots and ``cache_pos`` (an int)
    is the write position; the cache is written in place.  ``"encode"``
    is train without the causal mask.  With ``kv_source`` (B, S_enc, D),
    k and v are projected from it, unrotated, and attended without a
    mask (cross decode is :func:`cross_decode`).  Returns (y,
    new_cache): the prompt's KVCache in prefill, the encoder's KVCache
    under cross attention, the written cache in decode, None in train
    and encode.
    """
    b, s, _ = x.shape
    if kv_source is not None:
        if mode == "decode":
            raise ValueError("gqa_attention: cross decode is cross_decode")
        hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
        q = _proj(params, x, "q", cfg.n_heads, hd)
        k = _proj(params, kv_source, "k", nkv, hd)
        v = _proj(params, kv_source, "v", nkv, hd)
        new_cache = KVCache(k, v)
        q_offset, kv_valid, causal, window = 0, None, False, 0
    else:
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
# MLA: multi-head latent attention (MiniCPM3 / DeepSeek-V2)
# --------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg, dtype) -> dict:
    m = cfg.mla
    d, h, dev = cfg.d_model, cfg.n_heads, gen.device
    return {
        "w_dq": dense_init(gen, d, m.q_lora_rank, dtype),
        "q_norm": norm_init(m.q_lora_rank, "rms", dtype, dev),
        "w_uq": dense_init(gen, m.q_lora_rank,
                           h * (m.qk_nope_dim + m.qk_rope_dim), dtype),
        "w_dkv": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_dim, dtype),
        "kv_norm": norm_init(m.kv_lora_rank, "rms", dtype, dev),
        "w_uk": dense_init(gen, m.kv_lora_rank, h * m.qk_nope_dim, dtype),
        "w_uv": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, dtype),
        "w_o": dense_init(gen, h * m.v_head_dim, d, dtype,
                          scale=(h * m.v_head_dim) ** -0.5),
    }


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, S_max, kv_lora_rank), after kv_norm
    k_rope: torch.Tensor  # (B, S_max, qk_rope_dim), rotated


def mla_attention(params, x, cfg, *, positions, mode: str,
                  cache: Optional[MLACache] = None, cache_pos=None,
                  q_block: int = 1024, kv_block: int = 1024):
    """MLA: latent-compressed KV.  Train / prefill expand to the
    multi-head form (q and k of nope + rope dims, the rope part of k
    shared by the heads) through ``flash_attention``; decode uses the
    absorbed form in f32 (``q_nope . W_uk`` against the latent cache),
    so the cache stays (kv_lora + rope) wide, and writes both caches in
    place.  Returns (y, the prompt's MLACache in prefill, the written
    cache in decode, None in train)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim

    cq = apply_norm(params["q_norm"], x @ params["w_dq"], "rms")
    q = (cq @ params["w_uq"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    dkv = x @ params["w_dkv"]                                 # (B,S,rank+dr)
    c_kv = apply_norm(params["kv_norm"], dkv[..., :m.kv_lora_rank], "rms")
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(dkv[..., m.kv_lora_rank:][:, :, None, :], positions,
                        cfg.rope_theta)                       # (B,S,1,dr)

    if mode == "decode":
        if cache is None:
            raise ValueError("mla_attention: decode needs a cache")
        cc = _masked_cache_write(cache.c_kv, c_kv, cache_pos)
        cr = _masked_cache_write(cache.k_rope, k_rope[:, :, 0], cache_pos)
        s_max = cc.shape[1]
        ccf = cc.float()
        # absorbed: q_abs[b, 1, h, r] = q_nope . W_uk(r, h, dn)
        w_uk = params["w_uk"].reshape(m.kv_lora_rank, h, dn).float()
        q_abs = torch.einsum("bshd,rhd->bshr", q_nope.float(), w_uk)
        scores = torch.einsum("bshr,btr->bhst", q_abs, ccf)
        scores = scores + torch.einsum("bshd,btd->bhst", q_rope.float(),
                                       cr.float())
        scores = scores * (dn + dr) ** -0.5
        valid = (torch.arange(s_max, device=x.device)
                 <= cache_pos)[None, None, None]
        p = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", p, ccf)
        w_uv = params["w_uv"].reshape(m.kv_lora_rank, h, dv).float()
        y = torch.einsum("bshr,rhd->bshd", ctx, w_uv)
        y = y.reshape(b, s, h * dv).to(x.dtype)
        return y @ params["w_o"], MLACache(cc, cr)

    k_nope = (c_kv @ params["w_uk"]).reshape(b, s, h, dn)
    v = (c_kv @ params["w_uv"]).reshape(b, s, h, dv)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    new_cache = MLACache(c_kv, k_rope[:, :, 0]) if mode == "prefill" else None
    y = flash_attention(q_full, k, v, causal=True, q_block=q_block,
                        kv_block=kv_block)
    y = y.reshape(b, s, h * dv)
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


class WindowKVCache(NamedTuple):
    """Ring-buffer KV cache for sliding-window attention (O(window)
    memory): ``pos_slots`` holds each slot's absolute position (-1 =
    empty)."""
    k: torch.Tensor           # (B, W, H_kv, Dh)
    v: torch.Tensor
    pos_slots: torch.Tensor   # (W,) int32


def gqa_decode_window(params, x, cfg, *, cache: WindowKVCache,
                      cache_pos: int, positions):
    """Single-token decode against a ring-buffer window cache: k, v and
    the position written at slot ``cache_pos % W`` in place; the token
    attends to every slot written, not in its future and within W of
    it.  Returns (y (B, 1, D), the cache)."""
    b = x.shape[0]
    w = cache.k.shape[1]
    q, k, v = _qkv(params, x, cfg, positions)
    slot = cache_pos % w
    ck = _masked_cache_write(cache.k, k, slot)
    cv = _masked_cache_write(cache.v, v, slot)
    ps = cache.pos_slots
    ps[slot] = cache_pos
    valid = (ps >= 0) & (ps <= cache_pos) & (cache_pos - ps < w)
    y = _plain_decode_attn(q, ck, cv, valid[None, None, None])
    y = y.reshape(b, 1, cfg.n_heads * cfg.resolved_head_dim)
    return y @ params["w_o"], WindowKVCache(ck, cv, ps)


def cross_decode(params, x, cfg, *, cache: KVCache):
    """Cross-attention decode: the encoder's KV from prefill, static and
    unmasked.  Returns (y (B, 1, D), the cache)."""
    b = x.shape[0]
    hd, nq = cfg.resolved_head_dim, cfg.n_heads
    q = _proj(params, x, "q", nq, hd)
    mask = torch.ones((1, 1, 1, cache.k.shape[1]), dtype=torch.bool,
                      device=x.device)
    y = _plain_decode_attn(q, cache.k, cache.v, mask)
    y = y.reshape(b, 1, nq * hd)
    return y @ params["w_o"], cache
