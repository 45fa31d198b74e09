"""Attention token mixers of the port: GQA (+QKV bias, M-RoPE), MLA, and
encoder / cross attention, on one blocked online-softmax core
(``flash_attention``) as in the reference.

Shapes follow (B, S, H, Dh); a layer's KV cache is (B, S_max, H_kv, Dh),
an MLA layer's (B, S_max, kv_lora_rank) and (B, S_max, qk_rope_dim), a
cross-attention layer's (B, S_enc, H_kv, Dh) over the encoder's frames.

The reference's ``flash_attention`` is plain ``jnp`` (a scan over kv
blocks), not Pallas; the port keeps its numerics: scores in f32 (in
f64 for f64 inputs, ``layers.wide``), per kv
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

Over model ranks (:func:`head_split`), GQA runs on this rank's query
heads ``[r hq / m, (r + 1) hq / m)`` where the rules split the heads:
``w_q`` / ``b_q`` are column blocks, ``w_o`` a row block whose product
is summed over the ranks.  Where the KV heads split too, ``w_k`` /
``w_v`` / ``b_k`` / ``b_v`` are this rank's KV heads; where they do not
(8 KV heads over 16 ranks), they stay whole, the rank computes only the
KV heads its query heads read, and the gradient of those whole leaves,
partial on each rank, is summed over the ranks (``copy_to_model`` on
the leaf).  MLA and head counts the model size does not divide run
whole on every rank.

A decode cache holds the rank's KV heads over the whole sequence, or,
where ``optim/sharding.py::cache_seq_block`` cuts its sequence dim over
the model ranks (``DecodeState.seq_split``), the rank's block of the
sequence (of the window's slots, of the encoder's frames) for every KV
head.  The decode then attends over the block (:func:`_split_decode_attn`):
the scores' maximum and the sum of their exponentials are reduced over
the model ranks, and so is the product of the probabilities with the
block of V; only (B, H) and (B, H, Dh) partials cross the ranks, never
the cache.  Where the query heads split, the rank gathers every query
head first and keeps its heads of the result (a reduce-scatter in rank
order), which its row block of ``w_o`` reads; the new token's k and v
of every KV head are gathered where ``w_k`` / ``w_v`` are blocks and
projected by the rank where they are whole.  A prefill's caches hold the
rank's KV heads over the whole prompt; the decode state's conversion
(``launch/serve.py::state_from_prefill``) trades them for sequence
blocks of every KV head in one all-to-all (:func:`kv_spans` says which
rank holds which head).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.mesh import (all_reduce, copy_to_model,
                                   gather_from_model, max_over_model,
                                   reduce_from_model, reduce_scatter)
from repro_torch.models.layers import (apply_norm, dense_init, model_ranks,
                                       norm_init, split_axis, wide)
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
        qf = wide(qb[qi])                        # (B, Hkv, G, Bq, Dq)
        m = torch.full((b, hkv, g, q_block), NEG_INF, dtype=qf.dtype,
                       device=dev)
        lse = torch.zeros((b, hkv, g, q_block), dtype=qf.dtype, device=dev)
        acc = torch.zeros((b, hkv, g, q_block, dv), dtype=qf.dtype,
                          device=dev)
        for ki in range(nk):
            k_pos = ki * kv_block + torch.arange(kv_block, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qf,
                             wide(kb[ki])) * scale
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
                "bhgqk,bhkd->bhgqd", p, wide(vb[ki]))
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


def _rotate(t, cfg, positions):
    """``t`` rotated by RoPE, or by M-RoPE over (3, B, S) positions
    where ``cfg.mrope_sections`` is set; unrotated unless
    ``cfg.pos_kind == "rope"``."""
    if cfg.pos_kind != "rope":
        return t
    if cfg.mrope_sections is not None:
        return apply_mrope(t, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(t, positions, cfg.rope_theta)


def _rotate_qk(q, k, cfg, positions):
    return _rotate(q, cfg, positions), _rotate(k, cfg, positions)


class HeadSplit(NamedTuple):
    """This rank's share of a GQA layer's heads: ``ax`` the model axis
    the heads are split over (None: every head, the one-process path),
    ``nq`` query heads from ``q0``, ``nk`` KV heads from ``k0``,
    ``kv_tp`` whether ``w_k`` / ``w_v`` are blocks, and ``kv_of`` the
    local KV head of each local query head where the query heads do
    not group evenly over the local KV heads (else None)."""
    ax: object
    q0: int
    nq: int
    k0: int
    nk: int
    kv_tp: bool
    kv_of: Optional[tuple]


def head_split(cfg) -> HeadSplit:
    """The heads of ``cfg``'s GQA layers this rank computes, as the
    partition rules split them over the current mesh's model ranks."""
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    ax = split_axis("attn", "w_q", cfg, nq * hd)
    if ax is None:
        return HeadSplit(None, 0, nq, 0, nkv, False, None)
    kv_tp = split_axis("attn", "w_k", cfg, nkv * hd) is not None
    q0, q_l, k0, nk = _heads_of(cfg, ax.ranks, ax.index, kv_tp)
    g = nq // nkv
    even = kv_tp or g % q_l == 0 or (q_l % g == 0 and q0 % g == 0)
    kv_of = None if even else tuple((q0 + i) // g - k0 for i in range(q_l))
    return HeadSplit(ax, q0, q_l, k0, nk, kv_tp, kv_of)


def _heads_of(cfg, ranks: int, index: int, kv_tp: bool):
    """(first query head, query heads, first KV head, KV heads) of model
    rank ``index`` of ``ranks``: a block of the query heads, and the
    KV heads' block (``kv_tp``) or the KV heads its query heads read."""
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    q_l = nq // ranks
    q0 = index * q_l
    if kv_tp:
        return q0, q_l, index * (nkv // ranks), nkv // ranks
    g = nq // nkv
    k0 = q0 // g
    return q0, q_l, k0, (q0 + q_l - 1) // g + 1 - k0


def kv_spans(cfg):
    """(first KV head, KV heads) that each model rank's GQA layers
    compute under the current mesh, in rank order, or None where the
    heads do not split."""
    sp = head_split(cfg)
    if sp.ax is None:
        return None
    return [_heads_of(cfg, sp.ax.ranks, i, sp.kv_tp)[2:]
            for i in range(sp.ax.ranks)]


def _proj(params, x, name, heads, hd, sp: Optional[HeadSplit] = None):
    """``x @ w_<name> (+ b_<name>)`` as (B, S, heads, hd).  Under ``sp``
    a whole ``w_k`` / ``w_v`` (and bias) is cut to the rank's KV heads,
    its gradient summed over the ranks."""
    w = params[f"w_{name}"]
    b = params[f"b_{name}"] if f"b_{name}" in params else None
    if sp is not None and sp.ax is not None and name in ("k", "v") \
            and not sp.kv_tp:
        w = copy_to_model(w, sp.ax).narrow(1, sp.k0 * hd, sp.nk * hd)
        if b is not None:
            b = copy_to_model(b, sp.ax).narrow(0, sp.k0 * hd, sp.nk * hd)
    y = x @ w
    if b is not None:
        y = y + b
    return y.reshape(x.shape[0], x.shape[1], heads, hd)


def _expand_kv(k, sp: HeadSplit):
    """``k`` (B, S, nk, D) as one KV head a query head where the local
    query heads do not group evenly over the local KV heads."""
    if sp.kv_of is None:
        return k
    idx = torch.tensor(sp.kv_of, dtype=torch.int64, device=k.device)
    return k.index_select(2, idx)


def _out(params, y, sp: HeadSplit):
    """``y (B, S, nq * hd) @ w_o``, summed over the model ranks."""
    return reduce_from_model(y @ params["w_o"], sp.ax)


def _qkv(params, x, cfg, positions, sp: HeadSplit):
    """The rotated q (B, S, nq, Dh) and k, v (B, S, nk, Dh) of ``x``,
    the rank's heads of ``sp``."""
    hd = cfg.resolved_head_dim
    x = copy_to_model(x, sp.ax)
    q = _proj(params, x, "q", sp.nq, hd)
    k = _proj(params, x, "k", sp.nk, hd, sp)
    v = _proj(params, x, "v", sp.nk, hd, sp)
    q, k = _rotate_qk(q, k, cfg, positions)
    return q, k, v


def _every_kv_head(params, x, cfg, positions, sp: HeadSplit, k, v):
    """``k`` and ``v`` (B, S, nk, Dh) of the rank's KV heads as every KV
    head's: themselves on one process and where the heads stay whole;
    gathered over the model ranks (one message for both) where ``w_k`` /
    ``w_v`` are blocks; projected from ``x`` (rotated at ``positions``
    unless None) where they are whole."""
    if sp.ax is None:
        return k, v
    hd = cfg.resolved_head_dim
    if sp.kv_tp:
        kv = gather_from_model(torch.cat([k, v], dim=-1), sp.ax, 2)
        return kv[..., :hd], kv[..., hd:]
    k = _proj(params, x, "k", cfg.n_kv_heads, hd)
    v = _proj(params, x, "v", cfg.n_kv_heads, hd)
    return (k if positions is None else _rotate(k, cfg, positions)), v


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
    sp = head_split(cfg)
    hd = cfg.resolved_head_dim
    if kv_source is not None:
        if mode == "decode":
            raise ValueError("gqa_attention: cross decode is cross_decode")
        q = _proj(params, copy_to_model(x, sp.ax), "q", sp.nq, hd)
        src = copy_to_model(kv_source, sp.ax)
        k = _proj(params, src, "k", sp.nk, hd, sp)
        v = _proj(params, src, "v", sp.nk, hd, sp)
        new_cache = KVCache(k, v)
        q_offset, kv_valid, causal, window = 0, None, False, 0
    else:
        q, k, v = _qkv(params, x, cfg, positions, sp)
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
    y = flash_attention(q, _expand_kv(k, sp), _expand_kv(v, sp),
                        causal=causal, window=window, q_offset=q_offset,
                        kv_valid_len=kv_valid, q_block=q_block,
                        kv_block=kv_block)
    y = y.reshape(b, s, sp.nq * hd)
    return _out(params, y, sp), new_cache


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
                  q_block: int = 1024, kv_block: int = 1024,
                  seq_len: Optional[int] = None):
    """MLA: latent-compressed KV.  Train / prefill expand to the
    multi-head form (q and k of nope + rope dims, the rope part of k
    shared by the heads) through ``flash_attention``; decode uses the
    absorbed form in f32 (``q_nope . W_uk`` against the latent cache; an
    f64 model in f64, ``layers.wide``), so the cache stays (kv_lora +
    rope) wide, and writes both caches in place.  ``seq_len`` (decode):
    the caches hold this rank's block of their ``seq_len`` positions;
    the softmax is reduced over the model ranks and so is the context
    ``p @ c_kv`` (B, H, rank) before ``w_uv``.  Returns (y, the prompt's
    MLACache in prefill, the written cache in decode, None in train)."""
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
        part = _seq_part(seq_len, cache.c_kv.shape[1])
        ax, lo = part if part is not None else (None, 0)
        cc = _block_write(cache.c_kv, c_kv, cache_pos, part)
        cr = _block_write(cache.k_rope, k_rope[:, :, 0], cache_pos, part)
        s_max = cc.shape[1]
        ccf = wide(cc)
        # absorbed: q_abs[b, 1, h, r] = q_nope . W_uk(r, h, dn)
        w_uk = wide(params["w_uk"].reshape(m.kv_lora_rank, h, dn))
        q_abs = torch.einsum("bshd,rhd->bshr", wide(q_nope), w_uk)
        scores = torch.einsum("bshr,btr->bhst", q_abs, ccf)
        scores = scores + torch.einsum("bshd,btd->bhst", wide(q_rope),
                                       wide(cr))
        scores = scores * (dn + dr) ** -0.5
        valid = (lo + torch.arange(s_max, device=x.device)
                 <= cache_pos)[None, None, None]
        scores = torch.where(valid, scores, NEG_INF)
        if ax is None:
            p = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bhst,btr->bshr", p, ccf)
        else:
            p = _split_softmax(scores, ax)
            ctx = all_reduce(torch.einsum("bhst,btr->bshr", p, ccf), ax)
        w_uv = wide(params["w_uv"].reshape(m.kv_lora_rank, h, dv))
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
    s = torch.einsum("bqhgd,bshd->bhgqs", wide(qg),
                     wide(k)) * dq ** -0.5
    s = torch.where(mask[:, :, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", wide(p.to(v.dtype)), wide(v))
    return o.reshape(b, 1, hq, -1).to(q.dtype)


def _split_softmax(s, ax):
    """The softmax over the last dim of scores ``s`` whose dim is cut
    over the model ranks ``ax`` (masked entries ``NEG_INF``): the
    block's maximum, then the maximum over the ranks (exact, so
    ``exp(s - M)`` has one process's bits), the block's sum of the
    exponentials summed over the ranks in rank order.  A rank whose
    block is wholly masked adds zeros."""
    m = max_over_model(s.amax(dim=-1, keepdim=True), ax)
    e = torch.exp(s - m)
    return e / all_reduce(e.sum(dim=-1, keepdim=True), ax)


def _split_decode_attn(q, k, v, mask, ax, heads_ax):
    """:func:`_plain_decode_attn` of every query head ``q`` (B,1,Hq,D)
    over this rank's block of the sequence ``k`` / ``v`` (B,S_r,Hkv,D),
    every KV head, ``mask`` (.., S_r): :func:`_split_softmax`, the
    probabilities cast to the cache dtype as there, their product with
    the block of V summed over the model ranks ``ax``.  Returns every
    head (B,1,Hq,Dv), or, where the query heads split over
    ``heads_ax``, this rank's heads (a reduce-scatter in rank order),
    in q.dtype."""
    b, _, hq, dq = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, 1, hkv, hq // hkv, dq).to(k.dtype)
    s = torch.einsum("bqhgd,bshd->bhgqs", wide(qg),
                     wide(k)) * dq ** -0.5
    p = _split_softmax(torch.where(mask[:, :, None], s, NEG_INF), ax)
    o = torch.einsum("bhgqs,bshd->bqhgd", wide(p.to(v.dtype)), wide(v))
    o = o.reshape(b, 1, hq, -1)
    o = (reduce_scatter(o, ax, 2) if heads_ax is not None
         else all_reduce(o, ax))
    return o.to(q.dtype)


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


def _seq_part(seq_len: Optional[int], length: int):
    """(the model axis, the first position of this rank's block) of a
    cache of ``length`` slots that holds this rank's block of a
    sequence dim of ``seq_len`` cut over the model ranks, or None for a
    cache that holds its sequence whole (``seq_len`` None)."""
    if seq_len is None:
        return None
    ax = model_ranks()
    if ax is None or length * ax.ranks != seq_len:
        raise ValueError(f"a cache of {length} of {seq_len} positions cut "
                         f"over the model ranks decodes under their mesh "
                         f"(layers.use_mesh)")
    return ax, ax.index * length


def _block_write(cache_arr, new, at: int, part):
    """:func:`_masked_cache_write` at the whole sequence's position
    ``at``: under ``part`` (:func:`_seq_part`) by the rank whose block
    holds it, the other ranks writing nothing."""
    if part is None:
        return _masked_cache_write(cache_arr, new, at)
    ax, lo = part
    n = cache_arr.shape[1]
    if not 0 <= at < n * ax.ranks:
        raise IndexError(f"cache position {at} outside a cache of "
                         f"{n * ax.ranks} over {ax.ranks} ranks")
    if lo <= at < lo + n:
        _masked_cache_write(cache_arr, new, at - lo)
    return cache_arr


def _split_gqa(params, x, cfg, positions, sp: HeadSplit):
    """Every query head's q (B,1,Hq,Dh), gathered over the model ranks
    where the heads split, and the new token's k and v of every KV
    head (:func:`_every_kv_head`)."""
    q, k, v = _qkv(params, x, cfg, positions, sp)
    k, v = _every_kv_head(params, x, cfg, positions, sp, k, v)
    return gather_from_model(q, sp.ax, 2), k, v


def gqa_decode(params, x, cfg, *, cache: KVCache, cache_pos: int,
               positions, seq_len: Optional[int] = None):
    """Single-token decode against a full-length cache (written in
    place); ``seq_len`` (S_max): the cache holds this rank's block of it
    for every KV head, slot ``pos`` on rank ``pos // (S_max / m)``.
    Returns (y (B, 1, D), the cache)."""
    b = x.shape[0]
    sp = head_split(cfg)
    part = _seq_part(seq_len, cache.k.shape[1])
    if part is not None:
        ax, lo = part
        q, k, v = _split_gqa(params, x, cfg, positions, sp)
        ck = _block_write(cache.k, k, cache_pos, part)
        cv = _block_write(cache.v, v, cache_pos, part)
        mask = (lo + torch.arange(ck.shape[1], device=x.device)
                <= cache_pos)[None, None, None]
        y = _split_decode_attn(q, ck, cv, mask, ax, sp.ax)
        y = y.reshape(b, 1, sp.nq * cfg.resolved_head_dim)
        return _out(params, y, sp), KVCache(ck, cv)
    q, k, v = _qkv(params, x, cfg, positions, sp)
    ck = _masked_cache_write(cache.k, k, cache_pos)
    cv = _masked_cache_write(cache.v, v, cache_pos)
    s_max = ck.shape[1]
    mask = (torch.arange(s_max, device=x.device)
            <= cache_pos)[None, None, None]
    y = _plain_decode_attn(q, _expand_kv(ck, sp), _expand_kv(cv, sp), mask)
    y = y.reshape(b, 1, sp.nq * cfg.resolved_head_dim)
    return _out(params, y, sp), KVCache(ck, cv)


class WindowKVCache(NamedTuple):
    """Ring-buffer KV cache for sliding-window attention (O(window)
    memory): ``pos_slots`` holds each slot's absolute position (-1 =
    empty)."""
    k: torch.Tensor           # (B, W, H_kv, Dh)
    v: torch.Tensor
    pos_slots: torch.Tensor   # (W,) int32


def gqa_decode_window(params, x, cfg, *, cache: WindowKVCache,
                      cache_pos: int, positions,
                      seq_len: Optional[int] = None):
    """Single-token decode against a ring-buffer window cache: k, v and
    the position written at slot ``cache_pos % W`` in place; the token
    attends to every slot written, not in its future and within W of
    it.  ``seq_len`` (W): the cache holds this rank's block of the W
    slots (and of ``pos_slots``) for every KV head, slot ``s`` on rank
    ``s // (W / m)``.  Returns (y (B, 1, D), the cache)."""
    b = x.shape[0]
    sp = head_split(cfg)
    n = cache.k.shape[1]
    part = _seq_part(seq_len, n)
    if part is not None:
        ax, lo = part
        w = n * ax.ranks
        q, k, v = _split_gqa(params, x, cfg, positions, sp)
        slot = cache_pos % w
        ck = _block_write(cache.k, k, slot, part)
        cv = _block_write(cache.v, v, slot, part)
        ps = cache.pos_slots
        if lo <= slot < lo + n:
            ps[slot - lo] = cache_pos
        valid = (ps >= 0) & (ps <= cache_pos) & (cache_pos - ps < w)
        y = _split_decode_attn(q, ck, cv, valid[None, None, None], ax,
                               sp.ax)
        y = y.reshape(b, 1, sp.nq * cfg.resolved_head_dim)
        return _out(params, y, sp), WindowKVCache(ck, cv, ps)
    q, k, v = _qkv(params, x, cfg, positions, sp)
    slot = cache_pos % n
    ck = _masked_cache_write(cache.k, k, slot)
    cv = _masked_cache_write(cache.v, v, slot)
    ps = cache.pos_slots
    ps[slot] = cache_pos
    valid = (ps >= 0) & (ps <= cache_pos) & (cache_pos - ps < n)
    y = _plain_decode_attn(q, _expand_kv(ck, sp), _expand_kv(cv, sp),
                           valid[None, None, None])
    y = y.reshape(b, 1, sp.nq * cfg.resolved_head_dim)
    return _out(params, y, sp), WindowKVCache(ck, cv, ps)


def cross_decode(params, x, cfg, *, cache: KVCache,
                 seq_len: Optional[int] = None):
    """Cross-attention decode: the encoder's KV from prefill, static and
    unmasked; ``seq_len`` (the frames): the cache holds this rank's
    block of them for every KV head.  Returns (y (B, 1, D), the cache)."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    sp = head_split(cfg)
    q = _proj(params, copy_to_model(x, sp.ax), "q", sp.nq, hd)
    mask = torch.ones((1, 1, 1, cache.k.shape[1]), dtype=torch.bool,
                      device=x.device)
    part = _seq_part(seq_len, cache.k.shape[1])
    if part is not None:
        y = _split_decode_attn(gather_from_model(q, sp.ax, 2), cache.k,
                               cache.v, mask, part[0], sp.ax)
    else:
        y = _plain_decode_attn(q, _expand_kv(cache.k, sp),
                               _expand_kv(cache.v, sp), mask)
    y = y.reshape(b, 1, sp.nq * hd)
    return _out(params, y, sp), cache
