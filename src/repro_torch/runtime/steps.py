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

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fd
from repro_torch.kernels.topk import local_topk
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_update, decayed
from repro_torch.runtime.spans import span


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, remat: str = "full",
                    q_block: int = 1024, kv_block: int = 1024,
                    mesh=None, specs=None):
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

    ``mesh`` is made current for the step (``layers.use_mesh``), so MoE
    dispatches per data shard as the reference does under its mesh.  On
    one process that is all it changes.  Over a mesh whose axes span
    ranks, ``params`` and the moments hold this rank's blocks of the
    leaves (``specs``: ``optim/sharding.py::param_specs``) and ``batch``
    this rank's rows (``data/pipeline.py::device_put_batch``).  The step
    then

      * gathers every parameter over the data axes before the forward
        (``sharding.gather_leaf(..., axes=FSDP_AXES)``) and puts the
        blocks back after the backward: a leaf the specs put over
        ``model`` stays this rank's model block;
      * divides each microbatch's cross-entropy by the whole
        microbatch's labelled tokens (the ranks' counts summed first,
        so a mask that weights ranks unequally is counted right) and
        the auxiliary loss by the data ranks, so that the ranks' losses
        and gradients add up to the whole batch's;
      * sums each gradient over the data ranks in rank order and cuts it
        to this rank's block of the data axes
        (``sharding.reduce_leaf``: a reduce-scatter, every rank the same
        bits);
      * clips by the norm over the group (``adamw.global_norm``) and
        runs AdamW on the blocks.

    The model ranks of one data rank compute the same rows, each with
    its blocks: the products run split over the model ranks
    (``models/layers.py``), which exchange only activations, each
    collective paired with its conjugate in the backward.  So a model
    block's gradient is the block's own, and a leaf whole over
    ``model`` gets the same gradient bits on every model rank (a whole
    ``w_k`` / ``w_v`` that the rank cuts to the KV heads it computes
    gets partial gradients, summed over the model ranks in the
    backward).  The loss is the sum over data ranks, the same bits on
    every rank.

    Spans (``runtime/spans.py``): ``train_step`` around the whole step,
    ``forward`` (each microbatch's loss), ``backward`` (its
    ``autograd.grad``) and ``optimizer`` (AdamW, clipping included).
    """
    from repro_torch.models import layers as L
    over_ranks = mesh is not None and mesh.multi_rank
    if over_ranks:
        if specs is None:
            raise ValueError("a train step over ranks needs the "
                             "parameters' specs")
        from repro_torch.optim import sharding as S
        n_data = math.prod(ax.ranks for ax in S.rank_axes(
            mesh, S.FSDP_AXES))

    def loss_of(params, mb, n_tok=None):
        with span("forward"):
            return M.loss_fn(params, cfg, mb, remat=remat, q_block=q_block,
                             kv_block=kv_block, n_tok=n_tok)

    def grads_of(leaves, loss):
        with span("backward"):
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, gs)]

    def local_loss(params, mb, n_tok):
        """This rank's share of the whole batch's loss."""
        if not over_ranks:
            return loss_of(params, mb)[0]
        _, parts = loss_of(params, mb, n_tok)
        return parts["ce"] + parts["aux"] / n_data

    def token_counts(mbs):
        """Each microbatch's labelled tokens over the data ranks."""
        if not over_ranks:
            return [None] * microbatches
        counts = torch.stack([(mbs["labels"][i] >= 0).sum()
                              for i in range(microbatches)]).float()
        return list(torch.clamp_min(S.psum_axes(counts, mesh), 1.0))

    def train_step(params, opt_state, batch):
        with span("train_step"):
            return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        names, leaves = zip(*params.named_parameters())
        blocks = [p.data for p in leaves]
        if over_ranks:
            for n, p in zip(names, leaves):
                p.data = S.gather_leaf(p.data, specs[n], mesh,
                                       axes=S.FSDP_AXES)
        try:
            with L.use_mesh(mesh):
                if microbatches == 1:
                    n_tok = token_counts({k: x[None]
                                          for k, x in batch.items()})[0]
                    loss = local_loss(params, batch, n_tok)
                    grads = grads_of(leaves, loss)
                    loss = loss.detach()
                else:
                    mbs = {k: x.reshape((microbatches,
                                         x.shape[0] // microbatches)
                                        + tuple(x.shape[1:]))
                           for k, x in batch.items()}
                    n_tok = token_counts(mbs)
                    grads = [torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device) for p in leaves]
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=leaves[0].device)
                    for i in range(microbatches):
                        mb_loss = local_loss(
                            params, {k: x[i] for k, x in mbs.items()},
                            n_tok[i])
                        for acc, g in zip(grads, grads_of(leaves, mb_loss)):
                            acc += g.to(torch.float32)
                        loss = loss + mb_loss.detach()
                    for g in grads:
                        g /= microbatches
                    loss = loss / microbatches
        finally:
            for p, b in zip(leaves, blocks):
                p.data = b
        if over_ranks:
            grads = [S.reduce_leaf(g, specs[n], mesh)
                     for n, g in zip(names, grads)]
            loss = S.psum_axes(loss, mesh)
        with span("optimizer"):
            params, opt_state, om = adamw_update(
                dict(zip(names, grads)), opt_state, params, opt_cfg,
                decayed(params, cfg), mesh=mesh if over_ranks else None,
                specs=specs)
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
    f32 scores (over model ranks, this rank's (B, V_pad / ranks)
    block): (vals, idx).  ``mesh`` is current for the decode step
    (``layers.use_mesh``), so MoE dispatches per data shard.

    Over a mesh whose axes span ranks, ``state`` and ``tokens`` hold
    this rank's rows of the batch (its data block), the parameters are
    this rank's model blocks (whole over the data axes), and the step's
    logits are this rank's block of the vocabulary columns (its model
    peers' shards), which ``select`` hands the FD rounds as they are.
    The FD top-k runs across the model ranks of this data rank
    (``core/fd.py``), and every model rank gets the same values (and,
    under halving, the same indices).  The noise is drawn for the whole
    batch from ``gen`` (the same seed on every rank) and each rank keeps
    its rows, so the tokens are the one-process run's but for the split
    products' rounding.
    """
    from repro_torch.models import layers as L
    if algorithm not in ("fd", "cn", "cn_star"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    msize = mesh.shape.get("model", 1)
    over_ranks = mesh.multi_rank
    rounds = (fd.schedule_rounds(schedule, msize, mesh.device,
                                 mesh.axis("model") if over_ranks
                                 else None)
              if msize > 1 and algorithm == "fd" else None)
    if over_ranks:
        from repro_torch.optim import sharding as S
        data_entry = S._entry(S.batch_axes(mesh.shape))

    def select(scores):
        if msize > 1:
            return fd.fd_topk(scores, k, mesh, "model", schedule=schedule,
                              algorithm=algorithm, rounds=rounds)
        return local_topk(scores, k)

    def serve_step(params, state, tokens, gen, noise=None):
        with L.use_mesh(mesh):
            logits, new_state = M.decode_step(params, cfg, state, tokens)
        vals, idx = select(logits[:, 0].float())      # (B, V) the cast
        if noise is None:
            if over_ranks:
                whole = S.global_shape(vals.shape, (data_entry, None), mesh)
                noise = S.shard_leaf(gumbel(whole, gen), (data_entry, None),
                                     mesh)
            else:
                noise = gumbel(vals.shape, gen)
        return sample_topk(vals, idx, noise, temperature), new_state

    serve_step.select = select
    return serve_step
