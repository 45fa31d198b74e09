"""RWKV-6 "Finch" time mixing of the port: linear attention with a
data-dependent per-channel decay (arXiv:2404.05892).

Two evaluators, as in the reference:

  * ``rwkv6_scan``    — the per-token recurrence (decode, S == 1)
  * ``rwkv6_chunked`` — the chunkwise-parallel form (prefill), exact:
    every intra-chunk decay factor is an exp of a non-positive sum
    (cumsum differences about the chunk's ``mid``), and the chunks pass
    their information through the f32 state.

Both compute in f32 and keep the state (B, H, K, V) in f32 (in f64 for
f64 inputs: ``layers.wide``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, wide


# --------------------------------------------------------------------------
# core recurrence
# --------------------------------------------------------------------------

def rwkv6_scan(r, k, v, w, u, s0):
    """The recurrence, one token at a time.  r, k, v, w: (B, T, H, K);
    u: (H, K); s0: (B, H, K, V).

    o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1}
    + k_t v_t^T.  Returns (o (B, T, H, V) f32, S_T f32).
    """
    r, k, v, w = (wide(a) for a in (r, k, v, w))
    s = s0.to(r.dtype)
    out = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,K,V)
        out.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                s + u[..., None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(out, dim=1), s


def rwkv6_chunked(r, k, v, w, u, s0, chunk: int = 16):
    """The chunkwise-parallel form (see the module docstring): the
    sequence zero-padded to whole chunks of ``min(chunk, T)``, ``w``
    padded with 1.0 (no decay).  Returns (o (B, T, H, V) f32, S_T)."""
    b, t, h, kk = r.shape
    vv = v.shape[-1]
    c = min(chunk, t)
    pad = (-t) % c
    if pad:
        def zp(a, value=0.0):
            return F.pad(a, (0, 0, 0, 0, 0, pad), value=value)
        r, k, v, w = zp(r), zp(k), zp(v), zp(w, 1.0)
    n = (t + pad) // c

    f32 = torch.promote_types(r.dtype, torch.float32)   # as wide()
    rc = r.to(f32).reshape(b, n, c, h, kk)
    kc = k.to(f32).reshape(b, n, c, h, kk)
    vc = v.to(f32).reshape(b, n, c, h, vv)
    lw = torch.log(torch.clamp(w.to(f32), 1e-12, 1.0)).reshape(b, n, c, h,
                                                               kk)
    mask = (torch.arange(c, device=r.device)[:, None]
            > torch.arange(c, device=r.device)[None, :])
    s = s0.to(f32)
    out = []
    for i in range(n):
        r_c, k_c, v_c, lw_c = rc[:, i], kc[:, i], vc[:, i], lw[:, i]
        cum = torch.cumsum(lw_c, dim=1)       # inclusive  (B,C,H,K)
        cumx = cum - lw_c                     # exclusive-before-i

        # inter-chunk: o_i += (r_i * exp(cumx_i)) . S
        o = torch.einsum("bchk,bhkv->bchv", r_c * torch.exp(cumx), s)

        # intra-chunk (j < i): exp(cumx_i - cum_j) as exp(cumx_i - m) *
        # exp(m - cum_j), m the chunk's centre, both exponents within
        # half the chunk's decay range
        mid = 0.5 * (cum[:, :1] + cum[:, -1:])           # (B,1,H,K)
        qd = r_c * torch.exp(cumx - mid)
        kd2 = k_c * torch.exp(mid - cum)
        a = torch.einsum("bihk,bjhk->bhij", qd, kd2)     # (B,H,C,C)
        a = a * mask[None, None]
        o = o + torch.einsum("bhij,bjhv->bihv", a, v_c)

        # current-token bonus: o_i += (r_i * u) . (k_i v_i^T)
        au = torch.einsum("bihk,bihk->bih", r_c * u[None, None], k_c)
        o = o + au[..., None] * v_c

        # S' = diag(exp(cum_C)) S + sum_j (k_j exp(cum_C - cum_j)) v_j^T
        tot = cum[:, -1]                                  # (B,H,K)
        kd = k_c * torch.exp(tot[:, None] - cum)
        s = torch.exp(tot)[..., None] * s + torch.einsum(
            "bjhk,bjhv->bhkv", kd, v_c)
        out.append(o)
    o = torch.stack(out, dim=1).reshape(b, n * c, h, vv)[:, :t]
    return o, s


# --------------------------------------------------------------------------
# the time-mix layer
# --------------------------------------------------------------------------

def rwkv_init(gen: torch.Generator, cfg, dtype) -> dict:
    d, dev = cfg.d_model, gen.device
    # decay from slow to fast across the channels (the RWKV convention)
    ratio = torch.arange(d, dtype=torch.float32, device=dev) / max(d - 1, 1)
    decay_base = -6.0 + 5.0 * ratio ** 0.7
    u = 0.5 * (1.0 - ratio)
    return {
        "mu": torch.full((5, d), 0.5, dtype=dtype, device=dev),  # r,k,v,w,g
        "w_r": dense_init(gen, d, d, dtype),
        "w_k": dense_init(gen, d, d, dtype),
        "w_v": dense_init(gen, d, d, dtype),
        "w_g": dense_init(gen, d, d, dtype),
        "w_o": dense_init(gen, d, d, dtype),
        "decay_base": decay_base,
        "lora_wa": dense_init(gen, d, 32, dtype, scale=0.01),
        "lora_wb": dense_init(gen, 32, d, dtype, scale=0.01),
        "u": u,
        "ln_x": {"scale": torch.ones((d,), dtype=dtype, device=dev),
                 "bias": torch.zeros((d,), dtype=dtype, device=dev)},
    }


def apply_rwkv(params, x, cfg, *, state, x_prev, chunk: int | None = None):
    """RWKV-6 time mix.  x: (B, S, D); state: (B, H, K, V) f32; x_prev:
    (B, 1, D) f32.  Returns (y, (state', x's last token in f32)).  S == 1
    takes the recurrence, a longer S the chunked form."""
    b, s, d = x.shape
    kdim = cfg.recurrent.rwkv_head_dim
    h = d // kdim
    chunk = chunk or cfg.recurrent.chunk_size

    shifted = torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)
    mu = params["mu"].to(x.dtype)

    def mix(i):
        return x * mu[i] + shifted * (1 - mu[i])

    xr, xk, xv, xw, xg = (mix(i) for i in range(5))
    r = (xr @ params["w_r"]).reshape(b, s, h, kdim)
    k = (xk @ params["w_k"]).reshape(b, s, h, kdim)
    v = (xv @ params["w_v"]).reshape(b, s, h, kdim)
    g = F.silu(xg @ params["w_g"])

    # the data-dependent decay (Finch): w = exp(-exp(base + lora(xw)))
    adj = torch.tanh(xw @ params["lora_wa"]) @ params["lora_wb"]
    logit = params["decay_base"][None, None] + adj.to(
        params["decay_base"].dtype)
    w = torch.exp(-torch.exp(logit)).reshape(b, s, h, kdim)

    u = params["u"].reshape(h, kdim)
    if s == 1:
        o, state = rwkv6_scan(r, k, v, w, u, state)
    else:
        o, state = rwkv6_chunked(r, k, v, w, u, state, chunk)

    # per-head group norm (the population variance, as jnp.var)
    mean = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, correction=0)
    o = (o - mean) * torch.rsqrt(var + 1e-5)
    o = o.reshape(b, s, d).to(x.dtype)
    o = o * params["ln_x"]["scale"] + params["ln_x"]["bias"]

    y = (o * g) @ params["w_o"]
    return y, (state, wide(x[:, -1:]))


def rwkv_init_state(cfg, batch: int, device):
    """Zero (state (B, H, K, K), x_prev (B, 1, D)), both f32."""
    kdim = cfg.recurrent.rwkv_head_dim
    h = cfg.d_model // kdim
    return (torch.zeros((batch, h, kdim, kdim), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, 1, cfg.d_model), dtype=torch.float32,
                        device=device))
