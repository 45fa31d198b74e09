"""FD — fully-distributed top-k over a sharded score axis.

The paper's four phases, over the peers of a :class:`Mesh`
(``core/mesh.py``: the peers of a process are a tensor axis on its
device, and an axis may span processes):

  1. query forward     — implicit: every peer already holds the query.
  2. local execution   — ``local_topk`` over each peer's score shard (the
                         CUDA top-k kernel on the card).
  3. merge-and-backward— ``merge_scorelists`` over the ``ppermute``
                         rounds of ``core/topology.py``: a halving tree
                         (peer 0 = query originator), a doubling
                         butterfly, or a ring.
  4. data retrieval    — fetch only the k winning rows from their owners
                         (masked psum — at most k items cross the
                         network, the paper's m_rt <= 2k).

Baselines (paper §5.1):
  * CN  — every peer ships its *full* local data to the originator
          (all-gather of the raw scores).
  * CN* — every peer ships only its local k-list to the originator
          (all-gather of k-lists, merge at the root).

A port of the reference's ``repro/core/fd.py`` that keeps its bits.
The ``_shard`` functions take the per-peer layout ``(..., P, n_local)``
(row p is what device p holds under ``shard_map``) and return what
``shard_map`` returns: the replicated output, which is peer 0's.  Every
collective is done literally as the reference does it — zeros for the
peers that receive nothing, the broadcast and the retrieval as sums
over the peer axis — because the shortcuts differ in bits (-0.0 becomes
+0.0 in a sum, and an infinite row entry times a 0 mask is NaN).

Over ranks (``axis``: a :class:`~repro_torch.core.mesh.Axis` of more
than one rank), a rank passes its own L peers ``(..., L, n_local)`` and
gets its first local peer's list: rank 0's is the replicated output;
every rank's values equal it, and its indices do too under halving.
Under doubling and ring, rank r's indices are the one-process
``_peer_lists(...)[..., r * L, :]``: they may differ from rank 0's in
the order of tied scores, as the reference's devices' do.  The halving
broadcast is sent as peer 0's list plus +0.0 (the psum's bits: every
other term is +0.0), moving the bytes ``comm_bytes`` counts.

Spans (``runtime/spans.py``): ``fd.local`` (phase 2), ``fd.round`` a
merge round (``round=i``), ``fd.broadcast`` (halving's root broadcast),
``fd.cn`` and ``fd.cn_star`` (the baselines).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from repro_torch.core import mesh as M
from repro_torch.core import topology
from repro_torch.kernels.merge import merge_scorelists
from repro_torch.kernels.topk import local_topk
from repro_torch.runtime.spans import span

_ALGORITHMS = ("fd", "cn", "cn_star")


def schedule_rounds(schedule: str, axis_size: int, device,
                    axis: Optional[M.Axis] = None) -> List[Tuple]:
    """The merge rounds of ``schedule`` as index tensors on ``device``:
    one ``(Permutation, receivers)`` per round, ``receivers`` a bool
    mask over the local peers for halving and None for the others (every
    peer merges).  Over ranks (``axis``), each round holds this rank's
    local indices and its send and receive lists.  Built once per engine
    and reused by every call."""
    local = range(axis_size)
    if axis is not None and axis.ranks > 1:
        local = range(axis.offset, axis.offset + axis.local)
    if schedule == "halving":
        return [(M.permutation(perm, axis_size, device, axis),
                 torch.tensor([p in recv for p in local],
                              dtype=torch.bool, device=device))
                for perm, recv in topology.halving_rounds(axis_size)]
    if schedule == "doubling":
        rounds = topology.doubling_rounds(axis_size)
    elif schedule == "ring":
        rounds = topology.ring_rounds(axis_size)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return [(M.permutation(perm, axis_size, device, axis), None)
            for perm in rounds]


def _over_ranks(axis: Optional[M.Axis]) -> bool:
    return axis is not None and axis.ranks > 1


# --------------------------------------------------------------------------
# Per-peer collective top-k (the reference's in-shard_map functions)
# --------------------------------------------------------------------------

def _local_lists(local_scores: torch.Tensor, k: int,
                 axis: Optional[M.Axis] = None) -> tuple:
    """Phase 2 on every peer: its k-list with global indices."""
    with span("fd.local"):
        L, n_local = local_scores.shape[-2:]
        ax = M.axis_index(L, local_scores.device, axis)
        vals, idx = local_topk(local_scores, k)
        return vals, idx + (ax * n_local)[:, None]


def _peer_lists(local_scores: torch.Tensor, k: int, schedule: str,
                rounds: Optional[list],
                axis: Optional[M.Axis] = None) -> tuple:
    """Phases 2-3 on every peer: the (vals, idx) list each local peer
    ends with, (..., L, k).  Under doubling and ring the peers' lists
    can differ in the order of tied scores (each peer merges its
    partners in its own order); the retrieval reads every peer's own
    list, as the reference's does."""
    L = local_scores.shape[-2]
    dev = local_scores.device
    if rounds is None:
        rounds = schedule_rounds(schedule, axis.size if _over_ranks(axis)
                                 else L, dev, axis)
    vals, idx = _local_lists(local_scores, k, axis)

    if schedule == "doubling":
        for i, (perm, _) in enumerate(rounds):
            with span("fd.round", round=i):
                pv, pi = M.ppermute_all((vals, idx), perm, axis)
                vals, idx = merge_scorelists(vals, idx, pv, pi)
        return vals, idx

    if schedule == "halving":
        for i, (perm, recv) in enumerate(rounds):
            with span("fd.round", round=i):
                pv, pi = M.ppermute_all((vals, idx), perm, axis)
                # non-receivers got zeros; mask them to -inf so merge is
                # a no-op
                pv = torch.where(recv[:, None], pv, float("-inf"))
                pi = torch.where(recv[:, None], pi, -1)
                vals, idx = merge_scorelists(vals, idx, pv, pi)
        # peer 0 (query originator) holds the final score-list; broadcast
        # it (the retrieval-phase "ask" fan-out)
        with span("fd.broadcast"):
            if _over_ranks(axis):
                vals, idx = M.broadcast_all(
                    (vals[..., 0, :] + 0.0, idx[..., 0, :]), axis)
            else:
                root = (M.axis_index(L, dev) == 0)[:, None]
                vals = M.psum(torch.where(root, vals, 0.0))
                idx = M.psum(torch.where(root, idx, 0))
        shape = vals.shape[:-1] + (L, k)
        return (vals.unsqueeze(-2).expand(shape),
                idx.unsqueeze(-2).expand(shape))

    if schedule == "ring":
        # relay each peer's ORIGINAL k-list around the ring; merging the
        # accumulator would re-introduce duplicates of already-seen
        # lists.  Peer 0 merges peer P-1's list first, then P-2's, ...
        relay_v, relay_i = vals, idx
        for i, (perm, _) in enumerate(rounds):
            with span("fd.round", round=i):
                relay_v, relay_i = M.ppermute_all((relay_v, relay_i),
                                                  perm, axis)
                vals, idx = merge_scorelists(vals, idx, relay_v, relay_i)
        return vals, idx

    raise ValueError(f"unknown schedule {schedule!r}")


def fd_topk_shard(local_scores: torch.Tensor, k: int, *,
                  schedule: str = "halving",
                  rounds: Optional[list] = None,
                  axis: Optional[M.Axis] = None) -> tuple:
    """Global top-k of per-peer score shards ``(..., L, n_local)``.

    The global index of peer p's local column j is ``p * n_local + j``.
    ``rounds``: the cached ``schedule_rounds(schedule, P, device,
    axis)``; ``axis``: the peer axis when it spans ranks.  Returns
    (vals f32, idx int32) of shape (..., k): the first local peer's
    result.
    """
    vals, idx = _peer_lists(local_scores, k, schedule, rounds, axis)
    return vals[..., 0, :], idx[..., 0, :]


def cn_topk_shard(local_scores: torch.Tensor, k: int,
                  axis: Optional[M.Axis] = None) -> tuple:
    """CN baseline: all-gather the full scores, top-k locally (every
    peer computes the same list, so it is computed once a rank)."""
    with span("fd.cn"):
        return local_topk(M.all_gather(local_scores, axis), k)


def cn_star_topk_shard(local_scores: torch.Tensor, k: int,
                       axis: Optional[M.Axis] = None) -> tuple:
    """CN* baseline: all-gather only the k-lists, merge locally."""
    with span("fd.cn_star"):
        vals, idx = _local_lists(local_scores, k, axis)
        all_v = M.all_gather(vals, axis)                    # (..., k*P)
        all_i = M.all_gather(idx, axis)
        mv, pos = local_topk(all_v, k)
        return mv, torch.take_along_dim(all_i, pos.long(), dim=-1)


def fd_topk_gather_shard(local_scores: torch.Tensor,
                         local_rows: torch.Tensor, k: int, *,
                         schedule: str = "halving",
                         rounds: Optional[list] = None,
                         axis: Optional[M.Axis] = None) -> tuple:
    """Phases 2-4 over a sharded table: return the k winning *rows*.

    local_scores: (..., L, n_local) — leading dims are a query batch over
    the same table; local_rows: (L, n_local, d).  Only k rows per query
    cross the network (phase 4 = masked psum), vs CN's n_local * n rows.
    Returns (vals (..., k), idx (..., k), rows (..., k, d)).
    """
    L, n_local = local_scores.shape[-2:]
    ax = M.axis_index(L, local_scores.device, axis)
    vals, idx = _peer_lists(local_scores, k, schedule, rounds, axis)
    # Phase 4: data retrieval — each winner row is contributed by its
    # owner; every peer reads the clipped positions of its own list, its
    # mask zeroes what it does not own, and the sum over peers is the
    # retrieval (a real sum: an infinity under a 0 mask is NaN)
    owner = idx // n_local                                   # (..., L, k)
    local_pos = torch.clamp(idx - (ax * n_local)[:, None], 0, n_local - 1)
    mine = torch.arange(L, device=local_rows.device)[:, None]
    rows = local_rows[mine, local_pos.long()]                # (..., L, k, d)
    mask = (owner == ax[:, None])[..., None].to(local_rows.dtype)
    return (vals[..., 0, :], idx[..., 0, :],
            M.psum(rows * mask, dim=-3, axis=axis))


# --------------------------------------------------------------------------
# Mesh-level wrappers
# --------------------------------------------------------------------------

def _batch_axis(scores: torch.Tensor, mesh: M.Mesh,
                batch_axes) -> Optional[M.Axis]:
    """The reference's ``_batch_lead_spec`` over ranks: the mesh axis
    over ranks that splits the batch (the leading dim), or None.

    The batch is split when the reference shards it: ``batch_axes``
    present in the mesh whose sizes' product divides it.  Within a rank
    the split changes no bit, so it is split only over ranks, and then
    contiguously: each row's collectives are its own, so which rank
    takes which rows changes no bit either.
    """
    if not batch_axes or scores.dim() < 2:
        return None
    present = tuple(a for a in batch_axes if a in mesh.shape)
    if not present or scores.shape[0] % math.prod(
            mesh.shape[a] for a in present):
        return None
    over = [mesh.axis(a) for a in present if mesh.axis(a).ranks > 1]
    if len(over) > 1:
        raise ValueError(f"the batch can span the ranks of one mesh axis, "
                         f"not of {tuple(a.name for a in over)}")
    return over[0] if over else None


def _shards(scores: torch.Tensor, mesh: M.Mesh, axis: str,
            batch_axes) -> tuple:
    """(the per-peer view ``(..., L, n_local)`` of this rank's scores,
    the peer :class:`~repro_torch.core.mesh.Axis`, the batch's axis over
    ranks or None).

    ``scores`` (..., N / R) is this rank's block of the ``R`` ranks of
    ``axis`` (the whole (..., N) on one process).  Raises what the
    reference raises, before any collective: a block not divisible by
    the rank's peers, or indices that do not fit int32.  ``batch_axes``
    shards the batch over other mesh axes; within a rank that changes no
    bit, so there it is only checked, and over ranks each rank keeps its
    rows of the batch.
    """
    ax = mesh.axis(axis)
    if batch_axes is not None and axis in tuple(batch_axes):
        raise ValueError(f"the peer axis {axis!r} cannot also shard the "
                         "batch")
    n = scores.shape[-1]
    if ax.ranks == 1 and n % ax.size:
        raise ValueError(f"score dim {n} not divisible by axis {ax.size}")
    if n % ax.local:
        raise ValueError(f"score block {n} not divisible by the "
                         f"{ax.local} peers a rank of axis {axis!r}")
    if n * ax.ranks > 2 ** 31 - 1:
        raise ValueError(f"score dim {n * ax.ranks} does not fit int32 "
                         "indices")
    if scores.device != mesh.device:
        raise ValueError(f"scores on {scores.device}, mesh on {mesh.device}")
    bx = _batch_axis(scores, mesh, batch_axes)
    if bx is not None:
        part = scores.shape[0] // bx.ranks
        scores = scores[bx.index * part:(bx.index + 1) * part]
    local = scores.reshape(scores.shape[:-1] + (ax.local, n // ax.local))
    return local, (ax if ax.ranks > 1 else None), bx


def _whole_batch(out: tuple, bx: Optional[M.Axis]) -> tuple:
    """Each rank's rows of the batch gathered back into the whole
    batch, as the global array of ``shard_map`` is."""
    if bx is None:
        return out
    return tuple(M.gather_dim(t, bx, 0) for t in out)


def fd_topk(scores: torch.Tensor, k: int, mesh: M.Mesh, axis: str = "model",
            *, schedule: str = "halving", algorithm: str = "fd",
            batch_axes=None, rounds: Optional[list] = None) -> tuple:
    """Global top-k of ``scores`` (..., N) sharded over mesh axis ``axis``.

    Over ranks, ``scores`` is this rank's column block (..., N / R).
    algorithm: "fd" | "cn" | "cn_star".  ``rounds``: cached
    ``schedule_rounds`` (fd only).  Returns (vals, idx) of shape (..., k),
    replicated over ``axis`` (over ranks: this rank's first peer's).
    """
    if algorithm not in _ALGORITHMS:
        raise ValueError(algorithm)
    local, ax, bx = _shards(scores, mesh, axis, batch_axes)
    if algorithm == "fd":
        out = fd_topk_shard(local, k, schedule=schedule, rounds=rounds,
                            axis=ax)
    elif algorithm == "cn":
        out = cn_topk_shard(local, k, ax)
    else:
        out = cn_star_topk_shard(local, k, ax)
    return _whole_batch(out, bx)


def fd_topk_gather(scores: torch.Tensor, rows: torch.Tensor, k: int,
                   mesh: M.Mesh, axis: str = "model", *,
                   schedule: str = "halving", batch_axes=None,
                   rounds: Optional[list] = None) -> tuple:
    """Top-k rows of a sharded (N, d) table by sharded scores.

    scores: (..., N) — a leading batch of queries over the SAME table.
    rows: (N, d), sharded over ``axis`` only.  Over ranks, each is this
    rank's block: (..., N / R) and (N / R, d).
    Returns (vals (..., k), idx (..., k), rows (..., k, d)).
    """
    n = scores.shape[-1]
    if rows.dim() != 2 or rows.shape[0] != n:
        raise ValueError(f"rows must be ({n}, d), got {tuple(rows.shape)}")
    if rows.device != mesh.device:
        raise ValueError(f"rows on {rows.device}, mesh on {mesh.device}")
    local, ax, bx = _shards(scores, mesh, axis, batch_axes)
    L, n_local = local.shape[-2:]
    return _whole_batch(fd_topk_gather_shard(
        local, rows.reshape(L, n_local, -1), k, schedule=schedule,
        rounds=rounds, axis=ax), bx)


# --------------------------------------------------------------------------
# Communication model (matches paper §3.2)
# --------------------------------------------------------------------------

def comm_bytes(algorithm: str, n_dev: int, n_local: int, k: int,
               schedule: str = "halving", elem_bytes: int = 4) -> int:
    """Total bytes crossing links for one top-k query over n_dev shards."""
    if algorithm == "cn":
        return topology.allgather_bytes(n_dev, n_local, elem_bytes)
    if algorithm == "cn_star":
        return topology.allgather_bytes(n_dev, k, 8)
    if algorithm == "fd":
        merge = topology.schedule_list_bytes(schedule, n_dev, k)
        bcast = k * 8 * (n_dev - 1) if schedule == "halving" else 0
        return merge + bcast
    raise ValueError(algorithm)
