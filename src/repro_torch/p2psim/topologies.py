"""BRITE-style topology suite behind a registry (paper §5.1).

A copy of the reference package's ``p2psim.topologies``: the same
generators with the same RNG streams, so a family name, size and seed
build the same overlay (adjacency and coordinates) in both packages.

The paper validated FD "using the BRITE topology generator and
SimJava", but flat BA / Waxman overlays cover only a corner of what
BRITE models.  This module grows the repro's scenario diversity to the
families the topology-generation and P2P-search literature actually
distinguishes — power-law vs. random vs. hierarchical shapes trade
result quality against traffic very differently (see the Survey of
Search and Replication Schemes in Unstructured P2P Networks) — behind
a **registry** mirroring the ``Policy`` registry in
``repro_torch.engine.api``:

  * ``hierarchical``   — BRITE top-down two-level: an AS-level Waxman
    graph over AS centers, a router-level BA subgraph per AS placed
    around its center, stitched by gateway edges (one per AS-level
    edge).  Intra-AS links are short, inter-AS links long — the regime
    BRITE's hierarchical mode exists to produce;
  * ``gnutella``       — power-law BA core with uniform edge rewiring:
    the measured Gnutella shape (heavy-tailed degrees plus shortcut
    randomness from peers re-connecting through host caches);
  * ``small-world``    — Watts–Strogatz ring lattice with rewiring
    (high clustering, log diameter);
  * ``random-regular`` — union of d/2 random Hamiltonian cycles: an
    exactly d-regular connected graph, the degree-homogeneous control
    case;
  * plus the flat ``ba`` / ``waxman`` generators from
    :mod:`repro_torch.p2psim.graph`.

Every generator here returns a :class:`~repro_torch.p2psim.graph.Topology`
carrying per-node plane ``coords`` (flat BA excepted — it has no
natural embedding), which enable BRITE's distance-proportional
per-edge latency model: ``SimParams(latency_model="edge")`` makes
every link's latency ``lat_base_s + lat_scale_s * euclidean_distance``
instead of the i.i.d. N(200 ms, var) draw.  See
``docs/TOPOLOGIES.md`` for the full catalogue and
``docs/ARCHITECTURE.md`` for how the latencies thread through the
engine backends bit-exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.p2psim.graph import (Topology, _ba_adj, _components,
                                _to_topology, _waxman_adj,
                                barabasi_albert, waxman)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """One named topology family: builder + defaults + provenance.

    ``regime`` names which paper / BRITE regime the family models —
    surfaced by ``docs/TOPOLOGIES.md`` and the README topology table.
    """

    name: str
    builder: Callable[..., Topology]
    regime: str
    defaults: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, n: int, seed: int = 0, **overrides) -> Topology:
        """Build an ``n``-peer instance (defaults merged w/ overrides)."""
        kw = {**self.defaults, **overrides}
        return self.builder(n, seed=seed, **kw)


_REGISTRY: Dict[str, TopologySpec] = {}


def register_topology(spec: TopologySpec, *,
                      overwrite: bool = False) -> TopologySpec:
    """Add a topology family to the global registry (error on duplicate
    names unless ``overwrite``)."""
    if not overwrite and spec.name in _REGISTRY:
        raise ValueError(f"topology {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_topology(spec) -> TopologySpec:
    """Resolve a registered family name; a ``TopologySpec`` passes
    through."""
    if isinstance(spec, TopologySpec):
        return spec
    try:
        return _REGISTRY[spec]
    except KeyError:
        raise KeyError(f"unknown topology {spec!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def available_topologies() -> Tuple[str, ...]:
    """Registered family names, in registration order."""
    return tuple(_REGISTRY)


def build_topology(name, n: int, seed: int = 0, **overrides) -> Topology:
    """Build an ``n``-peer instance of a registered family."""
    return get_topology(name).build(n, seed=seed, **overrides)


# --------------------------------------------------------------------------
# generators
# --------------------------------------------------------------------------

def _bridge_chain(adj: List[set]) -> None:
    """Connect components by chaining one representative per component.

    Used by generators whose rewiring step can (rarely) disconnect the
    graph; adds ``n_components - 1`` edges, never nodes.
    """
    comp = _components(adj)
    k = int(comp.max()) + 1
    if k <= 1:
        return
    reps = [int(np.flatnonzero(comp == c)[0]) for c in range(k)]
    for a, b in zip(reps, reps[1:]):
        adj[a].add(b)
        adj[b].add(a)


def hierarchical(n: int, n_as: Optional[int] = None, m_router: int = 2,
                 as_alpha: float = 0.4, as_beta: float = 0.4,
                 as_avg_degree: float = 3.0, gw_per_edge: int = 1,
                 spread: float = 0.06, seed: int = 0) -> Topology:
    """BRITE-style two-level top-down hierarchical topology.

    ``n_as`` AS centers (default ``round(n ** (1/3))``, so 100k peers
    get ~46 ASes) are placed uniformly in the unit square and wired by
    an AS-level Waxman graph (``as_alpha`` / ``as_beta`` /
    ``as_avg_degree``, nearest-pair bridged to one component).  Each AS
    holds a router-level BA subgraph (``m_router``) whose nodes sit
    within ``spread`` of the AS center, so intra-AS links are short and
    inter-AS links long — exactly the latency structure BRITE's
    hierarchical mode produces.  Every AS-level edge is realized by
    ``gw_per_edge`` gateway edges between uniformly chosen routers of
    the two ASes.

    Connected by construction: each BA subgraph is connected, the AS
    graph is connected, and every AS edge contributes at least one
    gateway edge.
    """
    rng = np.random.default_rng(seed)
    if n_as is None:
        n_as = max(2, int(round(n ** (1.0 / 3.0))))
    n_as = max(1, min(n_as, n))
    centers = rng.random((n_as, 2))
    if n_as > 1:
        as_adj = _waxman_adj(centers, as_alpha, as_beta,
                             min(as_avg_degree, n_as - 1), rng)
    else:
        as_adj = [set()]
    sizes = np.full(n_as, n // n_as, dtype=np.int64)
    sizes[: n % n_as] += 1
    offs = np.concatenate([[0], np.cumsum(sizes)])
    adj: List[set] = [set() for _ in range(n)]
    coords = np.empty((n, 2))
    for a in range(n_as):
        sz = int(sizes[a])
        sub = _ba_adj(sz, min(m_router, max(sz - 1, 0)), rng)
        for u, nbrs in enumerate(sub):
            gu = int(offs[a]) + u
            for v in nbrs:
                adj[gu].add(int(offs[a]) + int(v))
        coords[offs[a]:offs[a + 1]] = (
            centers[a] + (rng.random((sz, 2)) - 0.5) * spread)
    np.clip(coords, 0.0, 1.0, out=coords)
    for a in range(n_as):
        for b in as_adj[a]:
            if a < b:
                for _ in range(gw_per_edge):
                    u = int(offs[a]) + int(rng.integers(sizes[a]))
                    v = int(offs[b]) + int(rng.integers(sizes[b]))
                    adj[u].add(v)
                    adj[v].add(u)
    return _to_topology(adj, "hierarchical", coords=coords)


def gnutella(n: int, m: int = 2, rewire_p: float = 0.10,
             seed: int = 0) -> Topology:
    """Gnutella-like overlay: BA power-law core + uniform rewiring.

    Each BA edge is, with probability ``rewire_p``, re-pointed from its
    higher endpoint to a uniformly random peer — the shortcut noise
    measured Gnutella snapshots show on top of the preferential-
    attachment backbone.  Rewires that would create a self-loop or a
    duplicate edge keep the original edge; components (rewiring can
    rarely split one off) are chain-bridged.  Coordinates are uniform
    in the unit square.
    """
    rng = np.random.default_rng(seed)
    adj = _ba_adj(n, m, rng)
    coords = rng.random((n, 2))
    edges = [(u, int(v)) for u in range(n) for v in adj[u] if u < v]
    flips = rng.random(len(edges)) < rewire_p
    targets = rng.integers(0, n, len(edges))
    for (u, v), flip, w in zip(edges, flips, targets):
        w = int(w)
        if not flip or w == u or w in adj[u] or v not in adj[u]:
            continue
        adj[u].discard(v)
        adj[v].discard(u)
        adj[u].add(w)
        adj[w].add(u)
    _bridge_chain(adj)
    return _to_topology(adj, "gnutella", coords=coords)


def small_world(n: int, k_ring: int = 4, rewire_p: float = 0.10,
                seed: int = 0) -> Topology:
    """Watts–Strogatz small world: ring lattice + random rewiring.

    Every node links to its ``k_ring // 2`` nearest neighbors on each
    side of a ring; each clockwise lattice edge is rewired to a uniform
    target with probability ``rewire_p`` (self-loops/duplicates keep
    the lattice edge).  Nodes are embedded on a circle, so the per-edge
    latency model sees short lattice hops and long chords.  Components
    are chain-bridged (rewiring can rarely disconnect).
    """
    rng = np.random.default_rng(seed)
    half = max(1, k_ring // 2)
    adj: List[set] = [set() for _ in range(n)]
    for j in range(1, half + 1):
        for u in range(n):
            v = (u + j) % n
            if u != v:
                adj[u].add(v)
                adj[v].add(u)
    for j in range(1, half + 1):
        flips = rng.random(n) < rewire_p
        targets = rng.integers(0, n, n)
        for u in np.flatnonzero(flips):
            u = int(u)
            v = (u + j) % n
            w = int(targets[u])
            if w == u or w in adj[u] or v not in adj[u]:
                continue
            adj[u].discard(v)
            adj[v].discard(u)
            adj[u].add(w)
            adj[w].add(u)
    _bridge_chain(adj)
    theta = 2.0 * np.pi * np.arange(n) / max(n, 1)
    coords = 0.5 + 0.48 * np.stack([np.cos(theta), np.sin(theta)], axis=1)
    return _to_topology(adj, "small-world", coords=coords)


def random_regular(n: int, d: int = 4, seed: int = 0,
                   max_tries: int = 100) -> Topology:
    """Random d-regular graph as a union of d/2 Hamiltonian cycles.

    Each cycle is a uniform permutation of the peers; a cycle that
    would duplicate an existing edge is redrawn (at most ``max_tries``
    times — collisions are O(1/n) rare).  Exactly d-regular, connected
    by construction (cycle 1 alone is Hamiltonian), no self-loops or
    multi-edges.  ``d`` must be even; coordinates are uniform.
    """
    if d < 2 or d % 2:
        raise ValueError(f"d must be even and >= 2, got {d}")
    if n <= d:
        raise ValueError(f"need n > d, got n={n}, d={d}")
    rng = np.random.default_rng(seed)
    adj: List[set] = [set() for _ in range(n)]
    for _ in range(d // 2):
        for _ in range(max_tries):
            perm = rng.permutation(n)
            es = [(int(perm[i]), int(perm[(i + 1) % n]))
                  for i in range(n)]
            if all(v not in adj[u] for u, v in es):
                break
        else:
            raise RuntimeError(
                f"no edge-disjoint Hamiltonian cycle after {max_tries} "
                f"draws (n={n}, d={d})")
        for u, v in es:
            adj[u].add(v)
            adj[v].add(u)
    coords = rng.random((n, 2))
    return _to_topology(adj, "random-regular", coords=coords)


# The family, named once (BRITE models + the shapes of the survey
# literature).  ``waxman`` is O(n^2) in memory — flat-overlay scale.
register_topology(TopologySpec(
    "ba", barabasi_albert,
    regime="BRITE 'BA' flat router model — Gnutella-shaped power law, "
           "d(G) ~ 2m (paper §5.1; no embedding, i.i.d. latency only)",
    defaults={"m": 2}))
register_topology(TopologySpec(
    "waxman", waxman,
    regime="BRITE 'RTWaxman' flat random-geometric model (O(n^2) "
           "build — flat-overlay scale)",
    defaults={"alpha": 0.15, "beta": 0.2, "avg_degree": 4.0}))
register_topology(TopologySpec(
    "hierarchical", hierarchical,
    regime="BRITE top-down hierarchical: AS-level Waxman over router-"
           "level BA, gateway-stitched; short intra-AS / long inter-AS "
           "links",
    defaults={"m_router": 2}))
register_topology(TopologySpec(
    "gnutella", gnutella,
    regime="measured Gnutella: power-law core + host-cache shortcut "
           "rewiring",
    defaults={"m": 2, "rewire_p": 0.10}))
register_topology(TopologySpec(
    "small-world", small_world,
    regime="Watts-Strogatz ring lattice + rewiring: high clustering, "
           "log diameter",
    defaults={"k_ring": 4, "rewire_p": 0.10}))
register_topology(TopologySpec(
    "random-regular", random_regular,
    regime="union of d/2 random Hamiltonian cycles: exactly d-regular "
           "degree-homogeneous control case",
    defaults={"d": 4}))
