"""Step builders of the port's LM paths.

  * ``make_train_step``   — grads (with microbatch accumulation) + AdamW
  * ``make_prefill_step`` — prompt -> (last logits, DecodeState)
  * ``make_serve_step``   — one decode token + FD top-k sampling over the
                            vocab-sharded logits (the paper's technique
                            as a serving feature)

The sampling is two plain functions, so that a test can hand the choice
the reference's own noise: :func:`gumbel` draws the noise from an
explicit ``torch.Generator``, and :func:`sample_topk` chooses among the
k winners by ``argmax(log(softmax(vals / T) + 1e-9) + noise)``, which is
``jax.random.categorical``'s rule.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fd
from repro_torch.kernels.topk import local_topk
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_update, decayed


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, remat: str = "full",
                    q_block: int = 1024, kv_block: int = 1024):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}): the gradients of ``M.loss_fn`` then
    :func:`adamw_update`, which updates ``params`` and the moments in
    place (the reference's step donates them).

    With ``microbatches`` > 1 the batch is split along its first dim and
    each part's gradients (``torch.autograd.grad``, in the parameters'
    dtype) are summed into f32 buffers, ``g_acc += g.float()``, as the
    reference's scan sums them; the sum and the loss are divided by
    ``microbatches``.  (Letting ``.grad`` accumulate in a bf16 parameter's
    dtype would round each partial sum there.)  A parameter the loss does
    not reach gets a zero gradient, as ``jax.grad`` gives it.
    """
    def loss_of(params, mb):
        return M.loss_fn(params, cfg, mb, remat=remat, q_block=q_block,
                         kv_block=kv_block)

    def grads_of(leaves, loss):
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, gs)]

    def train_step(params, opt_state, batch):
        names, leaves = zip(*params.named_parameters())
        if microbatches == 1:
            loss, _ = loss_of(params, batch)
            grads = grads_of(leaves, loss)
            loss = loss.detach()
        else:
            mbs = {k: x.reshape((microbatches, x.shape[0] // microbatches)
                                + tuple(x.shape[1:]))
                   for k, x in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(microbatches):
                mb_loss, _ = loss_of(params, {k: x[i]
                                              for k, x in mbs.items()})
                for acc, g in zip(grads, grads_of(leaves, mb_loss)):
                    acc += g.to(torch.float32)
                loss = loss + mb_loss.detach()
            for g in grads:
                g /= microbatches
            loss = loss / microbatches
        params, opt_state, om = adamw_update(dict(zip(names, grads)),
                                             opt_state, params, opt_cfg,
                                             decayed(params, cfg))
        return params, opt_state, {"loss": loss, **om}

    return train_step


# --------------------------------------------------------------------------
# prefill / serve
# --------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, *, q_block: int = 1024,
                      kv_block: int = 1024):
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, q_block=q_block,
                         kv_block=kv_block)
    return prefill_step


def gumbel(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` in f32 on the generator's
    device, ``-log(-log(u))`` with u uniform in [tiny, 1) as
    ``jax.random.gumbel`` draws it (from another stream of bits)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_topk(vals: torch.Tensor, idx: torch.Tensor, noise: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """One draw among the k winners of each row: vals (B, k) f32, idx
    (B, k) int32, noise (B, k).  Returns the chosen ids (B, 1) int32."""
    probs = torch.softmax(vals / temperature, dim=-1)
    choice = torch.argmax(torch.log(probs + 1e-9) + noise, dim=-1)
    return torch.take_along_dim(idx, choice[:, None], dim=-1).to(torch.int32)


def make_serve_step(cfg: ModelConfig, mesh, *, k: int = 20,
                    algorithm: str = "fd", schedule: str = "halving",
                    temperature: float = 1.0):
    """serve_step(params, state, tokens, gen, noise=None) ->
    (next_tokens (B, 1) int32, state').

    The vocabulary top-k is computed over the mesh's ``model`` axis of
    P virtual peers: with FD's merge-and-backward (``algorithm="fd"``,
    the rounds of ``schedule`` built once here), or the CN / CN*
    baselines; with P == 1 by ``local_topk``, whose order is
    ``lax.top_k``'s.  Both launch the top-k (and FD the merge) kernel
    on the card.  ``noise`` (B, k) replaces the draw from ``gen``.
    ``serve_step.select(scores)`` is that top-k alone, of (B, V_pad)
    f32 scores: (vals, idx).
    """
    if algorithm not in ("fd", "cn", "cn_star"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    msize = mesh.shape.get("model", 1)
    rounds = (fd.schedule_rounds(schedule, msize, mesh.device)
              if msize > 1 and algorithm == "fd" else None)

    def select(scores):
        if msize > 1:
            return fd.fd_topk(scores, k, mesh, "model", schedule=schedule,
                              algorithm=algorithm, rounds=rounds)
        return local_topk(scores, k)

    def serve_step(params, state, tokens, gen, noise=None):
        logits, new_state = M.decode_step(params, cfg, state, tokens)
        vals, idx = select(logits[:, 0].float())      # (B, V) the cast
        if noise is None:
            noise = gumbel(vals.shape, gen)
        return sample_topk(vals, idx, noise, temperature), new_state

    serve_step.select = select
    return serve_step
