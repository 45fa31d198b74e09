"""Overlay topologies: the flat generators and the CSR / BFS helpers.

A copy of the reference package's ``p2psim.graph``: :class:`Topology`,
the Barabási–Albert (BRITE "BA") and Waxman (BRITE "RTWaxman")
generators with the same constructions and RNG streams, so a seed gives
the same overlay (adjacency and coordinates) in both packages, the CSR
view, the vectorized first-touch BFS and the scalar flood
(``bfs_tree``, ``eccentricity_ttl``) that the scalar reference run
reads.  The rest of the family is in
:mod:`repro_torch.p2psim.topologies`.

:func:`topology_from_arrays` carries an overlay built elsewhere (the
reference package's, handed over as numpy arrays) into this package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Topology:
    """One overlay: adjacency lists + optional plane embedding.

    ``coords`` (n, 2), when present, define the per-edge latency model
    via :meth:`pair_latency`; generators that have no natural embedding
    (flat BA) leave it ``None`` and support only the i.i.d. latency
    draw.
    """

    n: int
    neighbors: List[np.ndarray]          # adjacency lists (sorted int32)
    kind: str = "ba"
    coords: Optional[np.ndarray] = None  # (n, 2) plane positions
    lat_base_s: float = 0.010            # propagation floor (s)
    lat_scale_s: float = 0.380           # seconds per unit distance

    @property
    def n_edges(self) -> int:
        """Number of undirected edges."""
        return sum(len(a) for a in self.neighbors) // 2

    def degree(self) -> np.ndarray:
        """(n,) node degrees."""
        return np.array([len(a) for a in self.neighbors])

    def avg_degree(self) -> float:
        """Mean degree d(G)."""
        return 2.0 * self.n_edges / self.n

    def edge_set(self):
        """Yield every undirected edge once as (u, v) with u < v."""
        for u in range(self.n):
            for v in self.neighbors[u]:
                if u < v:
                    yield (u, int(v))

    def pair_latency(self, u, v) -> np.ndarray:
        """BRITE-style latency of a (u, v) link from the embedding.

        ``lat_base_s + lat_scale_s * euclidean_distance`` — the
        distance-proportional propagation delay BRITE assigns to every
        edge.  ``u`` / ``v`` broadcast (scalar against array is fine);
        requires ``coords``.
        """
        if self.coords is None:
            raise ValueError(
                f"topology {self.kind!r} has no node coordinates; the "
                "per-edge latency model needs a coordinate-carrying "
                "generator (see repro_torch.p2psim.topologies)")
        cu = self.coords[u]
        cv = self.coords[v]
        d = np.sqrt(((cu - cv) ** 2).sum(axis=-1))
        return self.lat_base_s + self.lat_scale_s * d

    def edge_latencies(self, e_src: np.ndarray,
                       e_dst: np.ndarray) -> np.ndarray:
        """Per-edge latency array aligned with a directed edge list."""
        return self.pair_latency(e_src, e_dst)


def _to_topology(adj: List[set], kind: str,
                 coords: Optional[np.ndarray] = None) -> Topology:
    return Topology(
        n=len(adj),
        neighbors=[np.array(sorted(a), dtype=np.int32) for a in adj],
        kind=kind, coords=coords)


def _ba_adj(n: int, m: int, rng: np.random.Generator) -> List[set]:
    """BA preferential-attachment adjacency sets (``barabasi_albert``'s
    exact construction and RNG stream, reusable as a subgraph builder).
    """
    adj: List[set] = [set() for _ in range(n)]
    # seed clique of m+1 nodes
    core = min(m + 1, n)
    for u in range(core):
        for v in range(u + 1, core):
            adj[u].add(v)
            adj[v].add(u)
    # degree-proportional target sampling via repeated-endpoint list
    targets = []
    for u in range(core):
        targets.extend([u] * len(adj[u]))
    for u in range(core, n):
        chosen: set = set()
        while len(chosen) < min(m, u):
            cand = int(targets[rng.integers(len(targets))])
            if cand != u:
                chosen.add(cand)
        for v in chosen:
            adj[u].add(v)
            adj[v].add(u)
            targets.extend([u, v])
    return adj


def barabasi_albert(n: int, m: int = 2, seed: int = 0) -> Topology:
    """BA preferential attachment; avg degree -> 2m (paper's d(G)=4)."""
    rng = np.random.default_rng(seed)
    return _to_topology(_ba_adj(n, m, rng), "ba")


def _waxman_adj(pos: np.ndarray, alpha: float, beta: float,
                avg_degree: float, rng: np.random.Generator) -> List[set]:
    """Waxman adjacency sets over GIVEN positions (``waxman``'s exact
    edge-draw + nearest-pair bridging, reusable for the AS level of the
    hierarchical generator).  O(n^2) memory — flat-overlay scale only.
    """
    n = len(pos)
    d = np.sqrt(((pos[:, None] - pos[None]) ** 2).sum(-1))
    L = np.sqrt(2.0)
    p = beta * np.exp(-d / (alpha * L))
    np.fill_diagonal(p, 0.0)
    target_edges = avg_degree * n / 2.0
    p *= target_edges / max(p.sum() / 2.0, 1e-300)
    upper = np.triu(rng.random((n, n)) < p, k=1)
    adj: List[set] = [set() for _ in range(n)]
    for u, v in zip(*np.nonzero(upper)):
        adj[int(u)].add(int(v))
        adj[int(v)].add(int(u))
    # connect components along nearest pairs
    comp = _components(adj)
    while len(set(comp)) > 1:
        c0 = np.flatnonzero(comp == comp[0])
        c1 = np.flatnonzero(comp != comp[0])
        dd = d[np.ix_(c0, c1)]
        i, j = np.unravel_index(np.argmin(dd), dd.shape)
        u, v = int(c0[i]), int(c1[j])
        adj[u].add(v)
        adj[v].add(u)
        comp = _components(adj)
    return adj


def waxman(n: int, alpha: float = 0.15, beta: float = 0.2,
           avg_degree: float = 4.0, seed: int = 0) -> Topology:
    """Waxman: P(u~v) = beta * exp(-d(u,v) / (alpha * L)).

    Edge probability is globally rescaled to hit ``avg_degree``; the
    result is connected by bridging components along nearest pairs.
    The draw positions are kept as ``coords``, so Waxman overlays
    support the per-edge latency model.
    """
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 2))
    adj = _waxman_adj(pos, alpha, beta, avg_degree, rng)
    return _to_topology(adj, "waxman", coords=pos)


def _components(adj: List[set]) -> np.ndarray:
    n = len(adj)
    comp = -np.ones(n, dtype=np.int64)
    cur = 0
    for s in range(n):
        if comp[s] >= 0:
            continue
        stack = [s]
        comp[s] = cur
        while stack:
            u = stack.pop()
            for v in adj[u]:
                if comp[v] < 0:
                    comp[v] = cur
                    stack.append(v)
        cur += 1
    return comp


def topology_from_arrays(n: int, neighbors: Sequence[np.ndarray],
                         kind: str = "ba",
                         coords: Optional[np.ndarray] = None) -> Topology:
    """A :class:`Topology` from plain arrays (the ``Topology`` fields).

    ``neighbors[u]`` is u's adjacency list; it is stored sorted as
    int32, the layout every constructor here produces, so an overlay
    carried across from the reference package compiles to the same
    CSR, BFS trees and plans bit for bit.
    """
    if len(neighbors) != n:
        raise ValueError(f"got {len(neighbors)} adjacency lists for "
                         f"n={n} peers")
    return Topology(
        n=int(n),
        neighbors=[np.sort(np.asarray(a)).astype(np.int32)
                   for a in neighbors],
        kind=kind,
        coords=None if coords is None else np.asarray(coords,
                                                      np.float64))


def as_csr(top: Topology):
    """(indptr (n+1,), indices (2E,)) int64 CSR view of the adjacency.

    ``indices[indptr[u]:indptr[u+1]]`` are u's neighbors in sorted order —
    identical iteration order to ``top.neighbors[u]``.
    """
    counts = np.array([len(a) for a in top.neighbors], dtype=np.int64)
    indptr = np.zeros(top.n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    if indptr[-1]:
        indices = np.concatenate(top.neighbors).astype(np.int64)
    else:
        indices = np.zeros(0, dtype=np.int64)
    return indptr, indices


def directed_edges(indptr: np.ndarray, indices: np.ndarray):
    """(e_src, e_dst) for every directed edge, grouped by src ascending,
    dst sorted within src — the exact order of the per-peer Python loops
    the batched engine replaces."""
    e_src = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                      np.diff(indptr))
    return e_src, indices


def bfs_tree_csr(indptr: np.ndarray, indices: np.ndarray, origin: int,
                 ttl: int, return_rank: bool = False):
    """Vectorized-per-level BFS, bit-for-bit identical to the scalar
    flood of the reference package (``bfs_tree``).

    The scalar flood assigns ``parent[v]`` to the FIRST toucher —
    iterating the frontier in discovery order and neighbors in sorted
    order.  The
    same tie-break is reproduced here as the minimum position in the
    concatenated frontier-neighbor gather, so every downstream quantity
    (tree edges, wait times, merges) matches the scalar path exactly.

    With ``return_rank=True`` a fourth float64 array is returned:
    ``rank[v]`` = v's discovery index WITHIN ITS LEVEL (the frontier
    order), -1 for unreached nodes.  Ranks are only meaningful compared
    between same-depth nodes; they are the first-touch certificate the
    reference's live-overlay tree patch uses to decide
    claim priority without re-running the sweep (float so patched-in
    joins can take fractional slots between existing claims).
    """
    n = len(indptr) - 1
    parent = -np.ones(n, dtype=np.int64)
    depth = -np.ones(n, dtype=np.int64)
    depth[origin] = 0
    rank = None
    if return_rank:
        rank = -np.ones(n, dtype=np.float64)
        rank[origin] = 0.0
    frontier = np.array([origin], dtype=np.int64)
    # first-touch position scratch, allocated once; only the entries a
    # level touches are reset afterwards
    sentinel = np.iinfo(np.int64).max
    first = np.full(n, sentinel, dtype=np.int64)
    lvl = 0
    while len(frontier) and lvl < ttl:
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        # ragged gather of all frontier neighbor lists, in frontier order
        offs = np.repeat(np.cumsum(counts) - counts, counts)
        pos_in_row = np.arange(total, dtype=np.int64) - offs
        cand = indices[np.repeat(starts, counts) + pos_in_row]
        src = np.repeat(frontier, counts)
        new = depth[cand] < 0
        cand_new = cand[new]
        if len(cand_new) == 0:
            break
        pos = np.flatnonzero(new)
        np.minimum.at(first, cand_new, pos)
        uniq = np.unique(cand_new)
        order_new = uniq[np.argsort(first[uniq])]   # discovery order
        parent[order_new] = src[first[order_new]]
        depth[order_new] = lvl + 1
        if rank is not None:
            rank[order_new] = np.arange(len(order_new), dtype=np.float64)
        first[uniq] = sentinel
        frontier = order_new
        lvl += 1
    if return_rank:
        return parent, depth, depth >= 0, rank
    return parent, depth, depth >= 0


def bfs_tree_csr_multi(indptr: np.ndarray, indices: np.ndarray,
                       origins: np.ndarray, ttl: int,
                       return_rank: bool = False):
    """``bfs_tree_csr`` for MANY origins in one sweep.

    Returns (parent, depth, reached) each shaped (len(origins), n), row o
    bit-for-bit equal to ``bfs_tree_csr(indptr, indices, origins[o],
    ttl)``.  All origins advance level-synchronously; per-origin
    first-touch tie-breaks are preserved because candidate positions are
    only compared within the same (origin, node) key and the flattened
    frontier keeps every origin's discovery order as a subsequence.
    ``return_rank=True`` appends the per-origin within-level discovery
    ranks, row-for-row equal to the single-origin ones.
    """
    n = len(indptr) - 1
    S = len(origins)
    parent = -np.ones((S, n), dtype=np.int64)
    depth = -np.ones((S, n), dtype=np.int64)
    dflat = depth.reshape(-1)            # flat views: 1-d gathers are
    pflat = parent.reshape(-1)           # far cheaper than 2-d fancy ones
    rank = kflat = None
    if return_rank:
        rank = -np.ones((S, n), dtype=np.float64)
        kflat = rank.reshape(-1)
    ar = np.arange(S)
    depth[ar, origins] = 0
    if rank is not None:
        rank[ar, origins] = 0.0
    fr_org = ar.copy()
    fr_node = np.asarray(origins, dtype=np.int64).copy()
    # int32 sort keys radix-sort when the (origin, node) space fits
    kdt = np.int32 if S * n < 2**31 else np.int64
    lvl = 0
    while len(fr_node) and lvl < ttl:
        starts = indptr[fr_node]
        counts = indptr[fr_node + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        offs = np.repeat(np.cumsum(counts) - counts, counts)
        pos_in_row = np.arange(total, dtype=np.int64) - offs
        cand = indices[np.repeat(starts, counts) + pos_in_row]
        src = np.repeat(fr_node, counts)
        org = np.repeat(fr_org, counts)
        keyall = org * n + cand
        new = dflat[keyall] < 0
        key = keyall[new].astype(kdt)
        if len(key) == 0:
            break
        pos = np.flatnonzero(new)
        # grouped first-touch: stable (radix) sort by key keeps
        # candidate positions ascending within each (origin, node)
        # group, so the group leader IS the minimum position —
        # bit-identical to a minimum-reduce, without its scatter cost
        order = np.argsort(key, kind="stable")
        ks = key[order]
        lead = np.empty(len(ks), bool)
        lead[0] = True
        np.not_equal(ks[1:], ks[:-1], out=lead[1:])
        fpos = pos[order[lead]]          # min position per distinct key
        # positions are distinct, so the stable (radix) sort is exact
        dord = np.argsort(fpos.astype(kdt) if total < 2**31 else fpos,
                          kind="stable") # global discovery order
        okey = ks[lead][dord].astype(np.int64)
        pflat[okey] = src[fpos[dord]]
        dflat[okey] = lvl + 1
        if kflat is not None:
            # per-origin within-level rank: stable sort by origin keeps
            # the global discovery order inside each origin's group
            uorg = okey // n
            o2 = np.argsort(uorg, kind="stable")
            grp = uorg[o2]
            within = (np.arange(len(grp), dtype=np.int64)
                      - np.searchsorted(grp, grp))
            kflat[okey[o2]] = within.astype(np.float64)
        fr_org, fr_node = okey // n, okey % n
        lvl += 1
    if return_rank:
        return parent, depth, depth >= 0, rank
    return parent, depth, depth >= 0


def bfs_tree(top: Topology, origin: int, ttl: int):
    """(parent, depth, reached): the implicit spanning tree of the flood.

    parent[origin] = -1; unreached peers have depth = -1.
    """
    n = top.n
    parent = -np.ones(n, dtype=np.int64)
    depth = -np.ones(n, dtype=np.int64)
    depth[origin] = 0
    frontier = [origin]
    lvl = 0
    while frontier and lvl < ttl:
        nxt = []
        for u in frontier:
            for v in top.neighbors[u]:
                if depth[v] < 0:
                    depth[v] = lvl + 1
                    parent[v] = u
                    nxt.append(int(v))
        frontier = nxt
        lvl += 1
    return parent, depth, depth >= 0


def eccentricity_ttl(top: Topology, origin: int) -> int:
    """Smallest TTL reaching every peer (paper: TTL=12 reaches 10k)."""
    _, depth, _ = bfs_tree(top, origin, top.n)
    return int(depth.max())
