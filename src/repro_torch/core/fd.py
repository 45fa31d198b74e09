"""FD — fully-distributed top-k over a sharded score axis.

The paper's four phases, over the virtual peers of a :class:`Mesh`
(``core/mesh.py``: peers are a tensor axis on one device):

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
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core import mesh as M
from repro_torch.core import topology
from repro_torch.kernels.merge import merge_scorelists
from repro_torch.kernels.topk import local_topk

_ALGORITHMS = ("fd", "cn", "cn_star")


def schedule_rounds(schedule: str, axis_size: int, device) -> List[Tuple]:
    """The merge rounds of ``schedule`` as index tensors on ``device``:
    one ``(Permutation, receivers)`` per round, ``receivers`` a (P,)
    bool mask for halving and None for the others (every peer merges).
    Built once per engine and reused by every call."""
    if schedule == "halving":
        return [(M.permutation(perm, axis_size, device),
                 torch.tensor([p in recv for p in range(axis_size)],
                              dtype=torch.bool, device=device))
                for perm, recv in topology.halving_rounds(axis_size)]
    if schedule == "doubling":
        rounds = topology.doubling_rounds(axis_size)
    elif schedule == "ring":
        rounds = topology.ring_rounds(axis_size)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return [(M.permutation(perm, axis_size, device), None)
            for perm in rounds]


# --------------------------------------------------------------------------
# Per-peer collective top-k (the reference's in-shard_map functions)
# --------------------------------------------------------------------------

def _local_lists(local_scores: torch.Tensor, k: int) -> tuple:
    """Phase 2 on every peer: its k-list with global indices."""
    P, n_local = local_scores.shape[-2:]
    ax = M.axis_index(P, local_scores.device)
    vals, idx = local_topk(local_scores, k)
    return vals, idx + (ax * n_local)[:, None]


def _peer_lists(local_scores: torch.Tensor, k: int, schedule: str,
                rounds: Optional[list]) -> tuple:
    """Phases 2-3 on every peer: the (vals, idx) list each peer ends
    with, (..., P, k).  Under doubling and ring the peers' lists can
    differ in the order of tied scores (each peer merges its partners in
    its own order); the retrieval reads every peer's own list, as the
    reference's does."""
    P = local_scores.shape[-2]
    dev = local_scores.device
    if rounds is None:
        rounds = schedule_rounds(schedule, P, dev)
    vals, idx = _local_lists(local_scores, k)

    if schedule == "doubling":
        for perm, _ in rounds:
            vals, idx = merge_scorelists(vals, idx, M.ppermute(vals, perm),
                                         M.ppermute(idx, perm))
        return vals, idx

    if schedule == "halving":
        for perm, recv in rounds:
            # non-receivers got zeros; mask them to -inf so merge is a no-op
            pv = torch.where(recv[:, None], M.ppermute(vals, perm),
                             float("-inf"))
            pi = torch.where(recv[:, None], M.ppermute(idx, perm), -1)
            vals, idx = merge_scorelists(vals, idx, pv, pi)
        # peer 0 (query originator) holds the final score-list; broadcast
        # it (the retrieval-phase "ask" fan-out)
        root = (M.axis_index(P, dev) == 0)[:, None]
        vals = M.psum(torch.where(root, vals, 0.0))
        idx = M.psum(torch.where(root, idx, 0))
        shape = vals.shape[:-1] + (P, k)
        return (vals.unsqueeze(-2).expand(shape),
                idx.unsqueeze(-2).expand(shape))

    if schedule == "ring":
        # relay each peer's ORIGINAL k-list around the ring; merging the
        # accumulator would re-introduce duplicates of already-seen
        # lists.  Peer 0 merges peer P-1's list first, then P-2's, ...
        relay_v, relay_i = vals, idx
        for perm, _ in rounds:
            relay_v = M.ppermute(relay_v, perm)
            relay_i = M.ppermute(relay_i, perm)
            vals, idx = merge_scorelists(vals, idx, relay_v, relay_i)
        return vals, idx

    raise ValueError(f"unknown schedule {schedule!r}")


def fd_topk_shard(local_scores: torch.Tensor, k: int, *,
                  schedule: str = "halving",
                  rounds: Optional[list] = None) -> tuple:
    """Global top-k of per-peer score shards ``(..., P, n_local)``.

    The global index of peer p's local column j is ``p * n_local + j``.
    ``rounds``: the cached ``schedule_rounds(schedule, P, device)``.
    Returns (vals f32, idx int32) of shape (..., k): peer 0's result.
    """
    vals, idx = _peer_lists(local_scores, k, schedule, rounds)
    return vals[..., 0, :], idx[..., 0, :]


def cn_topk_shard(local_scores: torch.Tensor, k: int) -> tuple:
    """CN baseline: all-gather the full scores, top-k locally (every
    peer computes the same list, so it is computed once)."""
    return local_topk(M.all_gather(local_scores), k)


def cn_star_topk_shard(local_scores: torch.Tensor, k: int) -> tuple:
    """CN* baseline: all-gather only the k-lists, merge locally."""
    vals, idx = _local_lists(local_scores, k)
    all_v, all_i = M.all_gather(vals), M.all_gather(idx)    # (..., k*P)
    mv, pos = local_topk(all_v, k)
    return mv, torch.take_along_dim(all_i, pos.long(), dim=-1)


def fd_topk_gather_shard(local_scores: torch.Tensor,
                         local_rows: torch.Tensor, k: int, *,
                         schedule: str = "halving",
                         rounds: Optional[list] = None) -> tuple:
    """Phases 2-4 over a sharded table: return the k winning *rows*.

    local_scores: (..., P, n_local) — leading dims are a query batch over
    the same table; local_rows: (P, n_local, d).  Only k rows per query
    cross the network (phase 4 = masked psum), vs CN's n_local * n rows.
    Returns (vals (..., k), idx (..., k), rows (..., k, d)).
    """
    P, n_local = local_scores.shape[-2:]
    ax = M.axis_index(P, local_scores.device)
    vals, idx = _peer_lists(local_scores, k, schedule, rounds)
    # Phase 4: data retrieval — each winner row is contributed by its
    # owner; every peer reads the clipped positions of its own list, its
    # mask zeroes what it does not own, and the sum over peers is the
    # retrieval
    owner = idx // n_local                                   # (..., P, k)
    local_pos = torch.clamp(idx - (ax * n_local)[:, None], 0, n_local - 1)
    rows = local_rows[ax.long()[:, None], local_pos.long()]  # (..., P, k, d)
    mask = (owner == ax[:, None])[..., None].to(local_rows.dtype)
    return (vals[..., 0, :], idx[..., 0, :],
            M.psum(rows * mask, dim=-3))


# --------------------------------------------------------------------------
# Mesh-level wrappers
# --------------------------------------------------------------------------

def _shards(scores: torch.Tensor, mesh: M.Mesh, axis: str,
            batch_axes) -> torch.Tensor:
    """The per-peer view ``(..., P, n_local)`` of ``scores`` (..., N).

    Raises what the reference raises: N not divisible by the axis, or
    indices that do not fit int32.  ``batch_axes`` would shard the batch
    over other mesh axes; that changes no bit, so it is only checked.
    """
    if axis not in mesh.shape:
        raise ValueError(f"mesh {mesh} has no axis {axis!r}")
    if batch_axes is not None and axis in tuple(batch_axes):
        raise ValueError(f"the peer axis {axis!r} cannot also shard the "
                         "batch")
    n = scores.shape[-1]
    axis_size = mesh.shape[axis]
    if n % axis_size:
        raise ValueError(f"score dim {n} not divisible by axis {axis_size}")
    if n > 2 ** 31 - 1:
        raise ValueError(f"score dim {n} does not fit int32 indices")
    if scores.device != mesh.device:
        raise ValueError(f"scores on {scores.device}, mesh on {mesh.device}")
    return scores.reshape(scores.shape[:-1] + (axis_size, n // axis_size))


def fd_topk(scores: torch.Tensor, k: int, mesh: M.Mesh, axis: str = "model",
            *, schedule: str = "halving", algorithm: str = "fd",
            batch_axes=None, rounds: Optional[list] = None) -> tuple:
    """Global top-k of ``scores`` (..., N) sharded over mesh axis ``axis``.

    algorithm: "fd" | "cn" | "cn_star".  ``rounds``: cached
    ``schedule_rounds`` (fd only).  Returns (vals, idx) of shape (..., k),
    replicated over ``axis``.
    """
    if algorithm not in _ALGORITHMS:
        raise ValueError(algorithm)
    local = _shards(scores, mesh, axis, batch_axes)
    if algorithm == "fd":
        return fd_topk_shard(local, k, schedule=schedule, rounds=rounds)
    if algorithm == "cn":
        return cn_topk_shard(local, k)
    return cn_star_topk_shard(local, k)


def fd_topk_gather(scores: torch.Tensor, rows: torch.Tensor, k: int,
                   mesh: M.Mesh, axis: str = "model", *,
                   schedule: str = "halving", batch_axes=None,
                   rounds: Optional[list] = None) -> tuple:
    """Top-k rows of a sharded (N, d) table by sharded scores.

    scores: (..., N) — a leading batch of queries over the SAME table.
    rows: (N, d), sharded over ``axis`` only.
    Returns (vals (..., k), idx (..., k), rows (..., k, d)).
    """
    local = _shards(scores, mesh, axis, batch_axes)
    P, n_local = local.shape[-2:]
    if rows.dim() != 2 or rows.shape[0] != P * n_local:
        raise ValueError(f"rows must be ({P * n_local}, d), got "
                         f"{tuple(rows.shape)}")
    if rows.device != mesh.device:
        raise ValueError(f"rows on {rows.device}, mesh on {mesh.device}")
    return fd_topk_gather_shard(local, rows.reshape(P, n_local, -1), k,
                                schedule=schedule, rounds=rounds)


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
