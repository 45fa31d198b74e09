"""Plain reference of a MoE decoder's training steps (granite-3.0 MoE
widths), in f32 with TF32 off, and its seeded weights.

It follows the configuration file (Hugging Face keys, plus the ``port``
group of what the port's model does differently from the published
model, each a departure the reference takes too, so that the two compute
the same function):

* RMSNorm (eps ``rms_norm_eps``) before attention and before the MoE,
  and after the last layer;
* attention: q, k, v projections without bias, RoPE (``rope_theta``;
  the halves of each head rotated), causal softmax attention scaled by
  head_dim ** -0.5, grouped KV heads (query head h reads KV head h //
  (heads / KV heads)), the output projection;
* MoE: an f32 router, softmax, the ``num_experts_per_tok`` largest
  probabilities (the lowest expert on ties) renormalised to sum 1;
  SwiGLU experts; token dropping at capacity C = ceil(T * k / E *
  capacity_factor): the (token, slot) pairs sorted stably by expert, an
  expert keeping its first C; the load-balance loss E * sum(fraction *
  mean probability) * ``router_aux_loss_coef``, added to the loss;
* untied output head over ``padded_vocab_size`` columns (the padding
  rows are weights like any other), mean cross-entropy over the labels;
* AdamW with f32 moments, clipping by the global norm, linear warm-up
  then cosine decay, weight decay on every layer leaf and on the 2-D
  top-level leaves; each parameter updated in f32 and rounded to its
  stored dtype (bf16, the router f32).

``fp8=True`` computes every product whose operands the configuration
states in bf16 with both operands rounded to float8 e4m3 (a scale per
tensor, the rounding passed straight through in the backward): the
control, one precision below the configuration's.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


class Spec(NamedTuple):
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_expert: int
    experts: int
    top_k: int
    vocab: int
    vocab_padded: int
    rope_theta: float
    eps: float
    aux_coef: float
    capacity_factor: float
    dtype: torch.dtype            # the stored dtype of every leaf but
    #                               the router's (f32)


def spec_of(cfg: dict) -> Spec:
    """The reference's sizes from a configuration file's dict."""
    c, port = cfg["config"], cfg["port"]
    return Spec(c["num_hidden_layers"], c["hidden_size"],
                c["num_attention_heads"], c["num_key_value_heads"],
                c["hidden_size"] // c["num_attention_heads"],
                c["intermediate_size"], c["num_local_experts"],
                c["num_experts_per_tok"], c["vocab_size"],
                port["padded_vocab_size"], float(c["rope_theta"]),
                float(c["rms_norm_eps"]), float(c["router_aux_loss_coef"]),
                float(port["capacity_factor"]),
                getattr(torch, port["param_dtype"]))


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

class Leaf(NamedTuple):
    name: str
    shape: tuple
    scale: float          # 0.0: a norm scale, all ones
    dtype: torch.dtype


def leaves(s: Spec) -> List[Leaf]:
    """Every parameter, named as the port names it, in the order the
    seeded buffer is cut."""
    bf, f32 = s.dtype, torch.float32
    qd, kd = s.heads * s.head_dim, s.kv_heads * s.head_dim
    out = [Leaf("embed", (s.vocab_padded, s.d), 0.02, bf)]
    for i in range(s.layers):
        p = f"layers.{i}."
        out += [Leaf(p + "norm1.scale", (s.d,), 0.0, bf),
                Leaf(p + "norm2.scale", (s.d,), 0.0, bf),
                Leaf(p + "mixer.w_q", (s.d, qd), s.d ** -0.5, bf),
                Leaf(p + "mixer.w_k", (s.d, kd), s.d ** -0.5, bf),
                Leaf(p + "mixer.w_v", (s.d, kd), s.d ** -0.5, bf),
                Leaf(p + "mixer.w_o", (qd, s.d), qd ** -0.5, bf),
                Leaf(p + "ffn.router", (s.d, s.experts), 0.02, f32),
                Leaf(p + "ffn.w_gate", (s.experts, s.d, s.d_expert),
                     s.d ** -0.5, bf),
                Leaf(p + "ffn.w_up", (s.experts, s.d, s.d_expert),
                     s.d ** -0.5, bf),
                Leaf(p + "ffn.w_down", (s.experts, s.d_expert, s.d),
                     s.d_expert ** -0.5, bf)]
    out += [Leaf("norm_f.scale", (s.d,), 0.0, bf),
            Leaf("w_lm", (s.d, s.vocab_padded), s.d ** -0.5, bf)]
    return out


def make_weights(s: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``seed``: one f32 normal draw on ``device`` for
    every random leaf, cut in :func:`leaves`' order, each scaled and
    rounded to its dtype; norm scales are ones."""
    ls = leaves(s)
    total = sum(math.prod(lf.shape) for lf in ls if lf.scale)
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, dtype=torch.float32,
                       device=device)
    out, off = {}, 0
    for lf in ls:
        if not lf.scale:
            out[lf.name] = torch.ones(lf.shape, dtype=lf.dtype,
                                      device=device)
            continue
        n = math.prod(lf.shape)
        out[lf.name] = (flat[off:off + n].view(lf.shape)
                        * lf.scale).to(lf.dtype)
        off += n
    del flat
    return out


def decayed(name: str, ndim: int) -> bool:
    """Weight decay: every leaf of a layer (the layers are one stacked
    group), and a top-level leaf of two dims or more."""
    return name.startswith("layers.") or ndim >= 2


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale (its largest
    magnitude to 448), the rounding passed straight through."""
    scale = torch.clamp_min(x.detach().abs().amax(), 1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


def _mm(a, b, fp8: bool):
    if fp8:
        a, b = _q8(a), _q8(b)
    return a @ b


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x (B, S, H, Dh): the halves of each head rotated by position."""
    b, s, _, dh = x.shape
    half = dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attn_one(q, k, v, fp8):
    """One sequence: q (H, S, Dh), k and v (H, S, Dh) -> (H, S, Dh)."""
    s = q.shape[1]
    sc = _mm(q, k.transpose(1, 2), fp8) * q.shape[-1] ** -0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
    return _mm(p, v, fp8)


def _attention(x, w, s: Spec, fp8):
    b, t, _ = x.shape
    q = _mm(x, w["w_q"], fp8).view(b, t, s.heads, s.head_dim)
    k = _mm(x, w["w_k"], fp8).view(b, t, s.kv_heads, s.head_dim)
    v = _mm(x, w["w_v"], fp8).view(b, t, s.kv_heads, s.head_dim)
    q, k = _rope(q, s.rope_theta), _rope(k, s.rope_theta)
    g = s.heads // s.kv_heads
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    ys = [checkpoint(_attn_one, q[i].transpose(0, 1), k[i].transpose(0, 1),
                     v[i].transpose(0, 1), fp8, use_reentrant=False)
          for i in range(b)]
    y = torch.stack(ys).transpose(1, 2).reshape(b, t, s.heads * s.head_dim)
    return _mm(y, w["w_o"], fp8)


def route(probs: torch.Tensor, s: Spec):
    """(gates (T, k) renormalised, expert ids (T, k) int64, aux loss)."""
    ids = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True)[1][:, :s.top_k]
    gates = probs.gather(-1, ids)
    gates = gates / gates.sum(-1, keepdim=True)
    frac = (ids[..., None] == torch.arange(s.experts, device=ids.device)
            ).float().mean(dim=(0, 1))
    aux = s.experts * (frac * probs.mean(0)).sum() * s.aux_coef
    return gates, ids, aux


def _moe(x, w, s: Spec, fp8):
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    probs = torch.softmax(xf @ w["router"], dim=-1)
    gates, ids, aux = route(probs, s)
    cap = math.ceil(n * s.top_k / s.experts * s.capacity_factor)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=s.experts).tolist()
    yo = torch.zeros((n * s.top_k, d), dtype=xf.dtype, device=xf.device)
    start = 0
    for e, c in enumerate(counts):
        pairs = order[start:start + min(c, cap)]
        start += c
        if not len(pairs):
            continue
        xe = xf[pairs // s.top_k]
        h = F.silu(_mm(xe, w["w_gate"][e], fp8)) * _mm(xe, w["w_up"][e],
                                                       fp8)
        yo = yo.index_copy(0, pairs, _mm(h, w["w_down"][e], fp8))
    y = (yo.view(n, s.top_k, d) * gates[..., None]).sum(1)
    return y.view(b, t, d), aux


_LAYER_KEYS = ("norm1.scale", "norm2.scale", "mixer.w_q", "mixer.w_k",
               "mixer.w_v", "mixer.w_o", "ffn.router", "ffn.w_gate",
               "ffn.w_up", "ffn.w_down")


def _layer(x, s: Spec, fp8, *ws):
    w = {k.split(".")[-1] if k.startswith("mixer") or k.startswith("ffn")
         else k: t for k, t in zip(_LAYER_KEYS, ws)}
    x = x + _attention(_rms(x, w["norm1.scale"], s.eps), w, s, fp8)
    y, aux = _moe(_rms(x, w["norm2.scale"], s.eps), w, s, fp8)
    return x + y, aux


def _ce_chunk(h, w_lm, labels, fp8):
    logits = _mm(h, w_lm, fp8)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.clamp_min(0)[:, None])[:, 0]
    return ((lse - picked) * (labels >= 0)).sum()


def loss_of(w: Dict[str, torch.Tensor], s: Spec, tokens, labels, *,
            fp8: bool = False, chunk: int = 8192) -> torch.Tensor:
    """Cross-entropy plus every layer's load-balance loss; ``w`` f32
    leaves, ``tokens`` and ``labels`` (B, S) int64."""
    x = w["embed"][tokens]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s.layers):
        ws = [w[f"layers.{i}.{k}"] for k in _LAYER_KEYS]
        x, a = checkpoint(_layer, x, s, fp8, *ws, use_reentrant=False)
        aux = aux + a
    h = _rms(x, w["norm_f.scale"], s.eps).reshape(-1, s.d)
    lab = labels.reshape(-1)
    ce = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, h.shape[0], chunk):
        ce = ce + checkpoint(_ce_chunk, h[c0:c0 + chunk], w["w_lm"],
                             lab[c0:c0 + chunk], fp8, use_reentrant=False)
    return ce / torch.clamp_min((lab >= 0).sum(), 1) + aux


# --------------------------------------------------------------------------
# training steps
# --------------------------------------------------------------------------

class Opt(NamedTuple):
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float
    warmup_steps: int
    total_steps: int
    min_lr_ratio: float


def lr_at(o: Opt, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``."""
    warm = min(step / max(o.warmup_steps, 1), 1.0)
    t = min(max((step - o.warmup_steps)
                / max(o.total_steps - o.warmup_steps, 1), 0.0), 1.0)
    return o.lr * warm * (o.min_lr_ratio + (1 - o.min_lr_ratio)
                          * 0.5 * (1 + math.cos(math.pi * t)))


class Readings(NamedTuple):
    losses: List[float]
    grad_norms: Dict[str, float]      # the clipped first gradient
    delta_norms: Dict[str, float]     # |p after the steps - p before|


def train(s: Spec, o: Opt, weights: Dict[str, torch.Tensor], batches,
          *, fp8: bool = False) -> Readings:
    """Run ``len(batches)`` AdamW steps from ``weights`` (stored dtypes,
    updated in place) on ``batches`` ({"tokens", "labels"} tensors)."""
    prev = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(s, o, weights, batches, fp8)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def _train(s, o, weights, batches, fp8):
    start = {n: p.clone() for n, p in weights.items()}
    m = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for n, p in weights.items()}
    v = {n: torch.zeros_like(t) for n, t in m.items()}
    losses, first = [], {}
    for step, batch in enumerate(batches, start=1):
        w32 = {n: p.detach().float().requires_grad_()
               for n, p in weights.items()}
        loss = loss_of(w32, s, batch["tokens"].long(),
                       batch["labels"].long(), fp8=fp8)
        names = list(w32)
        grads = torch.autograd.grad(loss, [w32[n] for n in names])
        losses.append(float(loss.detach()))
        del w32, loss
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            clip = torch.clamp_max(o.grad_clip / torch.clamp_min(gnorm, 1e-12),
                                   1.0)
            lr = lr_at(o, step)
            b1c, b2c = 1 - o.b1 ** step, 1 - o.b2 ** step
            for n, g in zip(names, grads):
                g = g * clip
                if step == 1:
                    first[n] = float(torch.linalg.vector_norm(g))
                m[n].mul_(o.b1).add_((1 - o.b1) * g)
                v[n].mul_(o.b2).add_((1 - o.b2) * g * g)
                p = weights[n]
                pf = p.float()
                delta = (m[n] / b1c) / (torch.sqrt(v[n] / b2c) + o.eps)
                if decayed(n, p.ndim):
                    delta = delta + o.weight_decay * pf
                p.copy_((pf - lr * delta).to(p.dtype))
        del grads
    deltas = {n: float(torch.linalg.vector_norm(
        weights[n].float() - start[n].float())) for n in weights}
    return Readings(losses, first, deltas)
