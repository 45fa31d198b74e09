"""Mutable overlay: live :class:`Topology` mutations with versioning.

A copy of the reference package's ``p2psim.overlay``, line for line:
the journal, the tombstoning and the draw order of
:func:`random_session` are what the incremental plan sync and the
reference's tests read, so the two packages give the same overlays and
event lists for the same seeds.

The simulator's topologies are frozen snapshots; real unstructured P2P
networks churn BETWEEN queries too — peers join, leave, and the overlay
self-heals.  :class:`Overlay` is that live surface: it owns a
``Topology`` and exposes ``add_peer`` / ``remove_peer`` / ``add_edge`` /
``remove_edge``, each bumping a monotonically-increasing ``version`` and
appending a delta record to a journal.  ``repro_torch.engine.NetworkPlan``
keys its compiled caches on that version and patches them incrementally
(``NetworkPlan.sync``) instead of recompiling from scratch — see
docs/OVERLAY.md for the invalidation tiers.

Mutation semantics:

  * **Peer ids are stable.**  ``remove_peer`` TOMBSTONES: the departed
    peer keeps its id with an empty adjacency (``n`` never shrinks), so
    every cached per-node array stays aligned and a query from/through
    the tombstone degenerates naturally (BFS never reaches it).
    ``add_peer`` appends id ``n``.
  * **Adjacency invariants are preserved** — each ``neighbors[u]`` stays
    a sorted ``int32`` array (the CSR/BFS tie-break contract), and the
    arrays are replaced, never mutated in place, so snapshots taken by
    an un-synced plan stay internally consistent.
  * **Repair policies** run as part of ``remove_peer(pid, repair=...)``:
    the paper's self-healing story (a departed peer's neighbors
    reconnect) is ``"reconnect"``; policies are registered via
    :func:`register_repair` (mirroring the Policy/Topology registries —
    one surface in ``repro_torch.engine.registry``).

Session dynamics between queries ride on top: :func:`random_session`
draws a reproducible join/leave event stream and :func:`apply_events`
replays one onto an overlay.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.p2psim.graph import Topology

# --------------------------------------------------------------------------
# repair-policy registry (mirrors the Policy / Topology registries)
# --------------------------------------------------------------------------

# repair(overlay, pid, former_neighbors) -> None, called AFTER the
# departed peer's edges are gone; mutations it makes bump the version
RepairFn = Callable[["Overlay", int, np.ndarray], None]

_REPAIRS: Dict[str, RepairFn] = {}


def register_repair(name: str, fn: RepairFn) -> RepairFn:
    """Register an overlay self-healing policy under ``name``."""
    _REPAIRS[name] = fn
    return fn


def get_repair(name: str) -> RepairFn:
    """Look up a registered repair policy by name."""
    try:
        return _REPAIRS[name]
    except KeyError:
        raise KeyError(f"unknown repair policy {name!r}; registered: "
                       f"{available_repairs()}") from None


def available_repairs() -> Tuple[str, ...]:
    """Registered repair-policy names, sorted."""
    return tuple(sorted(_REPAIRS))


def _repair_none(ov: "Overlay", pid: int, former: np.ndarray) -> None:
    """No self-healing: the hole the departed peer leaves stays."""


def _repair_reconnect(ov: "Overlay", pid: int, former: np.ndarray) -> None:
    """The departed peer's neighbors reconnect pairwise along a chain.

    Consecutive former neighbors (ascending id) that are not already
    adjacent gain an edge — every path that used to run through the
    departed peer survives through the chain, so a connected overlay
    stays connected at the cost of ``deg - 1`` edges at most.
    """
    for a, b in zip(former[:-1], former[1:]):
        if not ov.has_edge(int(a), int(b)):
            ov.add_edge(int(a), int(b))


register_repair("none", _repair_none)
register_repair("reconnect", _repair_reconnect)


# --------------------------------------------------------------------------
# the mutable overlay
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OverlayDelta:
    """One journal record: the op plus the nodes whose adjacency changed."""

    version: int                  # version AFTER this mutation applied
    op: str                       # add_edge / remove_edge / add_peer / ...
    nodes: Tuple[int, ...]


class Overlay:
    """A live, versioned overlay wrapping one :class:`Topology`.

    ``Overlay(top)`` snapshots ``top`` (shallow copy of the adjacency
    list; per-node arrays are shared until replaced) so the caller's
    topology object is never mutated.  ``Overlay(top, copy=False)``
    adopts and mutates ``top`` in place.
    """

    def __init__(self, top: Topology, *, copy: bool = True):
        """Wrap (and by default snapshot) ``top``."""
        if copy:
            top = Topology(
                n=top.n, neighbors=list(top.neighbors), kind=top.kind,
                coords=None if top.coords is None else top.coords.copy(),
                lat_base_s=top.lat_base_s, lat_scale_s=top.lat_scale_s)
        self.top = top
        self._version = 0
        self._journal: List[OverlayDelta] = []

    # -- introspection -----------------------------------------------------

    @property
    def version(self) -> int:
        """Monotonically-increasing mutation counter (0 = as wrapped)."""
        return self._version

    @property
    def n(self) -> int:
        """Current peer-id space size (tombstones included)."""
        return self.top.n

    def degree(self, u: int) -> int:
        """Current degree of ``u`` (0 for tombstoned peers)."""
        return len(self.top.neighbors[u])

    def alive_peers(self) -> np.ndarray:
        """Ids of peers with at least one link (excludes tombstones)."""
        return np.flatnonzero(
            [len(a) > 0 for a in self.top.neighbors]).astype(np.int64)

    def has_edge(self, u: int, v: int) -> bool:
        """True when the undirected edge u–v exists."""
        a = self.top.neighbors[u]
        i = np.searchsorted(a, v)
        return bool(i < len(a) and a[i] == v)

    def deltas_since(self, version: int) -> List[OverlayDelta]:
        """Journal records applied after ``version`` (oldest first)."""
        return [d for d in self._journal if d.version > version]

    # -- mutations ---------------------------------------------------------

    def _check_node(self, u: int) -> int:
        u = int(u)
        if not 0 <= u < self.top.n:
            raise ValueError(f"peer id {u} out of range [0, {self.top.n})")
        return u

    def _record(self, op: str, nodes: Tuple[int, ...]) -> None:
        self._version += 1
        self._journal.append(OverlayDelta(self._version, op, nodes))

    @staticmethod
    def _insert(a: np.ndarray, v: int) -> np.ndarray:
        i = np.searchsorted(a, v)
        return np.insert(a, i, np.int32(v))

    @staticmethod
    def _delete(a: np.ndarray, v: int) -> np.ndarray:
        i = np.searchsorted(a, v)
        return np.delete(a, i)

    def add_edge(self, u: int, v: int) -> None:
        """Insert the undirected edge u–v (must not already exist)."""
        u, v = self._check_node(u), self._check_node(v)
        if u == v:
            raise ValueError(f"self-loop {u}-{v} not allowed")
        if self.has_edge(u, v):
            raise ValueError(f"edge {u}-{v} already exists")
        nb = self.top.neighbors
        nb[u] = self._insert(nb[u], v)
        nb[v] = self._insert(nb[v], u)
        self._record("add_edge", (u, v))

    def remove_edge(self, u: int, v: int) -> None:
        """Delete the undirected edge u–v (must exist)."""
        u, v = self._check_node(u), self._check_node(v)
        if not self.has_edge(u, v):
            raise ValueError(f"edge {u}-{v} does not exist")
        nb = self.top.neighbors
        nb[u] = self._delete(nb[u], v)
        nb[v] = self._delete(nb[v], u)
        self._record("remove_edge", (u, v))

    def add_peer(self, neighbors: Sequence[int] = (),
                 coords: Optional[Sequence[float]] = None) -> int:
        """Join a new peer (id ``n``) linked to ``neighbors``; returns
        its id.

        On a coordinate-carrying topology the new peer is placed at
        ``coords`` when given, else at the centroid of its neighbors
        (plane center when it joins link-less) — so the per-edge latency
        model keeps working on joined peers.
        """
        nbs = sorted({self._check_node(v) for v in neighbors})
        pid = self.top.n
        self.top.neighbors.append(np.zeros(0, np.int32))
        self.top.n = pid + 1
        if self.top.coords is not None:
            if coords is None:
                pos = (np.mean(self.top.coords[nbs], axis=0) if nbs
                       else np.full(2, 0.5))
            else:
                pos = np.asarray(coords, dtype=float)
            self.top.coords = np.vstack([self.top.coords, pos[None]])
        elif coords is not None:
            raise ValueError(
                f"topology {self.top.kind!r} carries no coordinates; "
                "cannot place the joining peer")
        self._record("add_peer", (pid,))
        for v in nbs:
            self.add_edge(pid, v)
        return pid

    def remove_peer(self, pid: int, repair: str = "none") -> np.ndarray:
        """Leave: tombstone ``pid`` (drop all incident edges, keep the
        id), then run the named repair policy over its former neighbors.
        Returns the former neighbor array."""
        pid = self._check_node(pid)
        fn = get_repair(repair)            # resolve BEFORE mutating
        nb = self.top.neighbors
        former = nb[pid].copy()
        for v in former:
            nb[v] = self._delete(nb[v], int(pid))
        nb[pid] = np.zeros(0, np.int32)
        self._record("remove_peer", (pid, *(int(v) for v in former)))
        fn(self, pid, former)
        return former


# --------------------------------------------------------------------------
# session dynamics: join/leave event streams between queries
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SessionEvent:
    """One session-dynamics event.

    ``kind="leave"`` removes ``peer``; ``kind="join"`` adds a fresh peer
    linked to ``neighbors`` (``peer`` is ignored on join — ids are
    assigned by the overlay).
    """

    kind: str                            # "join" | "leave"
    peer: int = -1
    neighbors: Tuple[int, ...] = ()


def random_session(overlay: Overlay, n_events: int, seed: int = 0,
                   join_prob: float = 0.5,
                   links_per_join: int = 2) -> List[SessionEvent]:
    """A reproducible join/leave stream against ``overlay``'s CURRENT
    state (events are drawn as if applied in order, so leave targets and
    join endpoints stay consistent under :func:`apply_events`)."""
    rng = np.random.default_rng(seed)
    alive = list(int(u) for u in overlay.alive_peers())
    next_id = overlay.n
    events: List[SessionEvent] = []
    for _ in range(n_events):
        if len(alive) > 1 and rng.random() >= join_prob:
            peer = alive.pop(int(rng.integers(len(alive))))
            events.append(SessionEvent("leave", peer=peer))
        else:
            m = min(links_per_join, len(alive))
            nbs = tuple(alive[int(i)] for i in
                        rng.choice(len(alive), size=m, replace=False))
            events.append(SessionEvent("join", neighbors=nbs))
            alive.append(next_id)
            next_id += 1
    return events


def apply_events(overlay: Overlay, events: Sequence[SessionEvent],
                 repair: str = "none") -> List[int]:
    """Replay ``events`` onto ``overlay`` (leaves run ``repair``);
    returns the ids assigned to the joins, in order."""
    joined: List[int] = []
    for ev in events:
        if ev.kind == "leave":
            overlay.remove_peer(ev.peer, repair=repair)
        elif ev.kind == "join":
            joined.append(overlay.add_peer(ev.neighbors))
        else:
            raise ValueError(f"unknown session event kind {ev.kind!r}")
    return joined
