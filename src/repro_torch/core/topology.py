"""Collective schedules: the TPU-native analogue of the paper's overlay.

The paper bubbles score-lists up a spanning tree of the (unstructured)
overlay; Strategies 1+2 ensure each edge carries the query once.  On a TPU
mesh we can pick the tree at compile time.  Three schedules are provided:

  * ``halving``   — recursive halving: the paper's merge-and-backward, with
                    device 0 as the query originator.  log2(n) rounds; a
                    link is used at most once per round and the total number
                    of list transfers is n-1 — the paper's Lemma 2 lower
                    bound (one message per non-originator peer).
  * ``doubling``  — recursive doubling (butterfly): every device ends with
                    the global top-k (no broadcast needed); n*log2(n)
                    transfers.
  * ``ring``      — n-1 rounds around a ring; n*(n-1) transfers but only
                    nearest-neighbour links (torus-friendly).

Each round is a `jax.lax.ppermute` permutation; `*_rounds(n)` return the
(src, dst) pair lists plus a per-device activity mask for merging.
"""
from __future__ import annotations

import math

from repro_torch.core.scorelist import ENTRY_BYTES

SCHEDULES = ("halving", "doubling", "ring")


def _log2(n: int) -> int:
    e = int(math.log2(n))
    if 2 ** e != n:
        raise ValueError(f"axis size {n} must be a power of two")
    return e


def doubling_rounds(n: int):
    """[(perm, None)] — every device both sends and merges each round."""
    return [[(i, i ^ (1 << r)) for i in range(n)] for r in range(_log2(n))]


def halving_rounds(n: int):
    """[(perm, receiver_set)] — bubble-up to originator (device 0).

    Round r: devices with idx % 2^(r+1) == 2^r send their list to
    idx - 2^r; only receivers merge.
    """
    rounds = []
    for r in range(_log2(n)):
        step = 1 << r
        senders = [i for i in range(n) if i % (2 * step) == step]
        perm = [(i, i - step) for i in senders]
        receivers = {i - step for i in senders}
        rounds.append((perm, receivers))
    return rounds


def ring_rounds(n: int):
    return [[(i, (i + 1) % n) for i in range(n)] for _ in range(n - 1)]


def schedule_transfers(schedule: str, n: int) -> int:
    """Number of k-list point-to-point transfers (paper's m_bw analogue)."""
    if schedule == "halving":
        return n - 1                      # == Lemma 2 lower bound
    if schedule == "doubling":
        return n * _log2(n)
    if schedule == "ring":
        return n * (n - 1)
    raise ValueError(schedule)


def schedule_list_bytes(schedule: str, n: int, k: int,
                        entry_bytes: int = ENTRY_BYTES) -> int:
    """Total bytes moved by the merge phase (all links summed)."""
    return schedule_transfers(schedule, n) * k * entry_bytes


def allgather_bytes(n: int, shard_elems: int, elem_bytes: int) -> int:
    """Total bytes for a ring all-gather of per-device shards (CN/CN*)."""
    return n * (n - 1) * shard_elems * elem_bytes


def measure_comm_bytes(algorithm: str, n_dev: int, n_local: int, k: int,
                       schedule: str = "halving",
                       elem_bytes: int = 4) -> int:
    """Bytes measured by *walking* the actual round structure.

    The closed forms in ``fd.comm_bytes`` / ``schedule_list_bytes`` are
    models; this tallies every point-to-point transfer the schedules
    actually emit — each ppermute pair moves one (score, index) k-list
    (``ENTRY_BYTES`` per couple), the halving epilogue broadcasts the
    originator's list to the other n-1 devices, and CN/CN* move their
    payload with a ring all-gather (n-1 rounds, one shard per device per
    round).  Tests assert this equals the closed-form model.
    """
    if algorithm == "cn":
        return _measure_ring_allgather(n_dev, n_local, elem_bytes)
    if algorithm == "cn_star":
        return _measure_ring_allgather(n_dev, k, ENTRY_BYTES)
    if algorithm != "fd":
        raise ValueError(algorithm)
    total = 0
    list_bytes = k * ENTRY_BYTES
    if schedule == "halving":
        for perm, _receivers in halving_rounds(n_dev):
            total += len(perm) * list_bytes
        total += (n_dev - 1) * k * ENTRY_BYTES     # originator broadcast
    elif schedule == "doubling":
        for perm in doubling_rounds(n_dev):
            total += len(perm) * list_bytes
    elif schedule == "ring":
        for perm in ring_rounds(n_dev):
            total += len(perm) * list_bytes
    else:
        raise ValueError(schedule)
    return total


def _measure_ring_allgather(n: int, shard_elems: int,
                            elem_bytes: int) -> int:
    """Ring all-gather, round by round: every device forwards one shard
    to its successor each of the n-1 rounds."""
    total = 0
    for _round in range(n - 1):
        for _dev in range(n):
            total += shard_elems * elem_bytes
    return total
