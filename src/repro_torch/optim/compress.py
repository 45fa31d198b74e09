"""FD top-k gradient compression for the slow cross-pod (DCN) axis.

The paper's insight applied to distributed optimization: never ship the
payload (the dense gradient) across the slow link — ship fixed-size
(score, address) lists and reconstruct.  Mapping:

  peer                  -> pod (the "pod" mesh axis, DCN-connected)
  local query execution -> per-block top-|g| selection (``local_topk``:
                           the top-k kernel on the card)
  score-list            -> (value, global index) k-lists per block
  merge-and-backward    -> all-gather of k-lists over pods
  data retrieval        -> sparse scatter-add of the k winners (only k
                           values ever cross the DCN, paper's m_rt <= 2k)
  k-inflation (Lemma 4) -> k_eff = k / (1 - p_drop) compensates pods whose
                           contribution is lost to failures
  urgent score-lists    -> error feedback: what wasn't sent this round is
                           accumulated and bubbles up in a later round

Compression ratio per tensor: dense 4*n bytes -> 8*k_eff bytes per pod.

A port of the reference's ``repro/optim/compress.py`` that keeps its
bits.  The pods of one process are a leading tensor axis ``(L, ...)``;
over ranks (a mesh whose ``"pod"`` axis spans processes) each rank holds
its own pods and the k-lists cross ranks by ``all_gather``.  The sparse
sum adds the pods' lists in pod order, one ``index_add_`` a pod (each
list's indices are distinct), as the reference's scatter-add does on
the CPU: one ``index_add_`` of every list at once adds an index that
several pods chose in any order on the card.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch

from repro_torch.core import mesh as M
from repro_torch.kernels.topk import local_topk


def inflate_k(k: int, p_drop: float) -> int:
    """Paper Lemma 4: request k/(1-P) so that k survive in expectation."""
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"p_drop must be in [0,1), got {p_drop}")
    return int(math.ceil(k / (1.0 - p_drop)))


class CompressState(NamedTuple):
    """Error-feedback accumulator, same tree structure as the grads."""
    ef: object


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a nested mapping (and of ``rest``,
    mappings of the same structure)."""
    if isinstance(tree, Mapping):
        return {key: _tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def compress_init(grads_like) -> CompressState:
    return CompressState(_tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_like))


# --------------------------------------------------------------------------
# per-tensor local phase (pure — unit-testable without a mesh)
# --------------------------------------------------------------------------

def topk_sparsify(g: torch.Tensor, k: int, ef: torch.Tensor):
    """Select the k largest-|.| entries of (g + ef).

    Returns (vals (k,), idx (k,), new_ef) where new_ef holds everything
    NOT selected (error feedback).  vals are the signed values.
    """
    acc = g.to(torch.float32).reshape(-1) + ef.reshape(-1)
    mag = torch.abs(acc)
    _, idx = local_topk(mag, k)
    pos = idx.long()
    vals = acc[pos]
    new_ef = acc.index_fill(0, pos, 0.0).reshape(ef.shape)
    return vals, idx, new_ef


def sparse_to_dense(vals, idx, n: int):
    return torch.zeros((n,), dtype=torch.float32,
                       device=vals.device).index_add_(0, idx.long(), vals)


def _sparse_sum(all_v: torch.Tensor, all_i: torch.Tensor, n: int):
    """The (P, k) lists of every pod added into zeros in pod order."""
    dense = torch.zeros((n,), dtype=torch.float32, device=all_v.device)
    for v, i in zip(all_v, all_i):
        dense.index_add_(0, i.long(), v)
    return dense


# --------------------------------------------------------------------------
# distributed phase: FD merge of sparse contributions over the pod axis
# --------------------------------------------------------------------------

def fd_sparse_allreduce_shard(g, ef, *, k: int, axis: M.Axis):
    """The reference's in-``shard_map`` function over the pods of
    ``axis``: approximate mean of ``g``.

    ``g`` and ``ef`` (L, ...) are this rank's L pods stacked.  Each pod
    ships only its k-list; every pod reconstructs the sparse sum.
    Returns (g_hat (...), new_ef (L, ...)): ``g_hat`` is the same on
    every pod.  Exact when the union of selections covers all
    non-zeros.
    """
    lists = [topk_sparsify(g[p], k, ef[p]) for p in range(g.shape[0])]
    vals = torch.stack([v for v, _, _ in lists])             # (L, k)
    idx = torch.stack([i for _, i, _ in lists])
    new_ef = torch.stack([e for _, _, e in lists])
    return _mean_of_lists(vals, idx, g[0], axis), new_ef


def _mean_of_lists(vals, idx, like, axis: M.Axis):
    """Every pod's k-list gathered over ``axis`` (k*P couples on the
    wire, vs n dense values for the baseline all-reduce) and their mean
    shaped and typed as ``like``."""
    all_v = M.gather_dim(vals, axis, 0)                      # (P, k)
    all_i = M.gather_dim(idx, axis, 0)
    dense = _sparse_sum(all_v, all_i, like.numel())
    g_hat = (dense / axis.size).reshape(like.shape)
    return g_hat.to(like.dtype)


def fd_sparse_allreduce(grads, ef_state: CompressState, mesh: M.Mesh,
                        *, axis: str = "pod", k_frac: float = 1e-3,
                        p_drop: float = 0.0):
    """Tree-wise compressed mean over the ``axis`` mesh axis.

    ``grads`` is a nested mapping of tensors.  On one process every pod
    sees the same gradients, as the reference's replicated ``in_specs``
    give them; over ranks each rank passes its own, which its local pods
    share.  k per leaf = inflate_k(max(1, int(k_frac * n)), p_drop).
    Returns (g_hat, CompressState(new_ef)): the first local pod's error
    feedback.
    """
    ax = mesh.axis(axis)

    def leaf_fn(g, ef):
        k = inflate_k(max(1, int(k_frac * g.numel())), p_drop)
        # the local pods' lists are one list repeated: compute it once
        vals, idx, new_ef = topk_sparsify(g, k, ef)
        vals = vals.expand(ax.local, k)
        idx = idx.expand(ax.local, k)
        return _mean_of_lists(vals, idx, g, ax), new_ef

    out = _tree_map(leaf_fn, grads, ef_state.ef)
    g_hat = _tree_map(lambda o: o[0], out)
    new_ef = _tree_map(lambda o: o[1], out)
    return g_hat, CompressState(new_ef)


def compression_ratio(n: int, k: int, n_pods: int) -> float:
    """Dense all-reduce bytes / FD compressed bytes (per DCN link)."""
    dense = 4 * n * 2 * (n_pods - 1) / n_pods       # ring all-reduce
    sparse = 8 * k * (n_pods - 1)                   # k-lists each way
    return dense / max(sparse, 1)
