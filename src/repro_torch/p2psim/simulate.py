"""Host side of the overlay sweeps: parameters, draws, per-origin
statics and the shared epilogue.

A copy of the pieces of the reference package's ``p2psim.simulate``
that the FD, churn and CN / CN* paths read, kept verbatim so the two
packages share one RNG-draw contract: every stochastic input of a query
is drawn here in numpy, in the scalar reference's exact order
(``_precompute_draws``), so the port's device sweep and the reference's
sweeps see the same bits and parity is a statement about sweep math
alone.

  * ``SimParams`` (Table 1 of the paper) and the Appendix-A wait budget;
  * the link, score and churn draws (``EntryDraws``);
  * ``_OriginStatic`` — one origin's BFS tree, levels, child CSR and
    forward-phase edge masks, and ``_OriginStatic.patched``, which
    re-derives them after a small overlay mutation (the live-overlay
    sync of ``repro_torch.engine.plan``);
  * the epilogue the sweep hands over to: urgent-list acceptance at
    the origin (§4.1), the §4.2 reroute message count, ground-truth
    top-k, and the retrieval phase with optional replica placement;
  * the CN / CN* baselines given the sweep's arrival times
    (``_cn_entries``);
  * the scalar reference run (``run_query_reference``, with the forward
    message count ``forward_messages``), which the two-round
    ``fd-stats`` heuristic runs on the host, and the latency-model
    helpers (``_latency_mode``, ``_tree_edge_latency``);
  * the retired entry points ``run_query``, ``run_queries`` and
    ``run_statistics_heuristic``: thin shims over
    ``repro_torch.engine.SimEngine`` that raise unless
    ``REPRO_LEGACY_API=1``, each with a ``device`` keyword for the
    engine.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import os
import warnings
from typing import Optional

import numpy as np

from repro_torch.p2psim.graph import Topology, as_csr, bfs_tree, bfs_tree_csr
from repro_torch.p2psim.metrics import (ENTRY_BYTES_PAPER, QUERY_BYTES,
                                        BatchMetrics, QueryMetrics)


@dataclasses.dataclass
class SimParams:
    """Table 1 of the paper."""
    k: int = 20
    ttl: int = 0                    # 0 -> auto (reach everyone)
    latency_mean_s: float = 0.200   # N(200 ms, var 100 ms^2)
    latency_var: float = 0.100 ** 2
    bw_mean_Bps: float = 56_000.0 / 8.0      # 56 kbps
    bw_var: float = (32_000.0 / 8.0) ** 2
    tuples_lo: int = 1000
    tuples_hi: int = 20000
    item_mean_B: float = 1024.0     # result data item ~ N(1 KB, ...)
    item_std_B: float = 256.0
    exec_s_per_tuple: float = 2e-5  # T_exec(Q) ~ 0.02..0.4 s
    merge_s: float = 0.002          # T_Merge(k)
    lam_max_s: float = 0.05         # Strategy-1 random wait λ
    request_B: int = 50
    # Appendix-A wait-time cost parameters (MAX estimates)
    t_qsnd_s: float = 0.5
    t_exec_max_s: float = 0.5
    t_slsnd_s: float = 0.5
    seed: int = 0
    # "iid"  — per-link latency ~ N(latency_mean_s, latency_var), the
    #          paper's Table-1 draw (default; RNG streams unchanged);
    # "edge" — per-edge latency from the topology's plane embedding
    #          (BRITE's distance-proportional delay, see
    #          Topology.pair_latency); needs a coordinate-carrying
    #          generator.  Bandwidths stay
    #          i.i.d. draws in both models.
    latency_model: str = "iid"
    # Replication (survey-motivated churn mitigation): every peer's
    # top-k items live on `replication_factor` additional peers, chosen
    # by the registered `replication_placement` policy ("random" /
    # "neighbor" — see register_placement).  At the FD retrieval phase a
    # dead owner's items are fetched from its first alive replica; an
    # item is lost only when the owner AND all its replicas are gone.
    # The placement table is a deterministic property of the overlay
    # (fixed internal seed, NOT the query stream), so `=0` leaves every
    # drawn bit unchanged and the CN baselines are unaffected.
    replication_factor: int = 0
    replication_placement: str = "random"


# --------------------------------------------------------------------------
# local query execution: exact top-k order statistics of n uniforms
# --------------------------------------------------------------------------

def local_topk_scores(n_tuples: np.ndarray, k: int,
                      rng: np.random.Generator) -> np.ndarray:
    """(P, k) descending top-k of n_i U[0,1] scores, sampled exactly:
    top-1 = U^(1/n); successive gaps via the Rényi representation."""
    p = len(n_tuples)
    u = rng.random((p, k))
    out = np.empty((p, k))
    cur = np.ones(p)
    remaining = n_tuples.astype(np.float64)
    for j in range(k):
        cur = cur * u[:, j] ** (1.0 / np.maximum(remaining, 1.0))
        out[:, j] = cur
        remaining -= 1.0
    return out


def wait_time(ttl_rem: np.ndarray, p: SimParams) -> np.ndarray:
    """Appendix A formula (2)."""
    t = ttl_rem.astype(np.float64)
    return (t * p.t_qsnd_s + p.t_exec_max_s + t * p.t_slsnd_s
            + np.maximum(t - 1.0, 0.0) * p.merge_s)


def _link_time(nbytes: float, lat: np.ndarray, bw: np.ndarray) -> np.ndarray:
    return lat + nbytes / bw


def _draw_link(rng, p: SimParams, size):
    lat = np.maximum(rng.normal(p.latency_mean_s,
                                math.sqrt(p.latency_var), size), 1e-3)
    bw = np.maximum(rng.normal(p.bw_mean_Bps, math.sqrt(p.bw_var), size),
                    1_000.0)
    return lat, bw


def _draw_bw(rng, p: SimParams, size):
    """Bandwidth-only draw — the ``latency_model="edge"`` link draw.

    The latency half of ``_draw_link`` is deterministic (the embedding
    distance), so the stream advances by the bandwidth normals ONLY;
    every backend uses this same helper, which is what keeps the edge
    model's streams aligned across reference / numpy / jax.
    """
    return np.maximum(rng.normal(p.bw_mean_Bps, math.sqrt(p.bw_var), size),
                      1_000.0)


def _latency_mode(top: Topology, p: SimParams) -> bool:
    """Validate ``p.latency_model`` against ``top``; True = edge mode."""
    if p.latency_model not in ("iid", "edge"):
        raise ValueError(
            f"latency_model must be 'iid' or 'edge', "
            f"got {p.latency_model!r}")
    if p.latency_model == "edge" and top.coords is None:
        raise ValueError(
            f"latency_model='edge' needs node coordinates; topology "
            f"{top.kind!r} has none (use a coordinate-carrying "
            "generator from repro_torch.p2psim.topologies)")
    return p.latency_model == "edge"


def _tree_edge_latency(top: Topology, parent: np.ndarray) -> np.ndarray:
    """(n,) latency of each node's tree edge v <-> parent(v) from the
    embedding (positions without a parent hold the floor value — never
    read by the sweeps)."""
    safe = np.maximum(parent, 0)
    lat = top.pair_latency(np.arange(top.n), safe)
    return np.where(parent >= 0, lat, top.lat_base_s)


# --------------------------------------------------------------------------
# replication: placement registry + retrieval-fallback model
# --------------------------------------------------------------------------

# placement(indptr, indices, r, rng) -> (n, r) replica peer ids (-1 pad)
_PLACEMENTS: dict = {}

# the placement table is a property of the NETWORK, not of any query:
# it is drawn from this fixed internal stream so every backend — and
# every per-entry seed — sees the same table, and the query RNG streams
# never move
_PLACEMENT_STREAM = 0x5EED_0FAB


def register_placement(name: str, fn) -> None:
    """Register a replica placement policy under ``name``."""
    _PLACEMENTS[name] = fn


def get_placement(name: str):
    """Look up a registered replica placement policy by name."""
    try:
        return _PLACEMENTS[name]
    except KeyError:
        raise KeyError(
            f"unknown replication placement {name!r}; registered: "
            f"{available_placements()}") from None


def available_placements() -> tuple:
    """Registered placement-policy names, sorted."""
    return tuple(sorted(_PLACEMENTS))


def _place_random(indptr, indices, r: int, rng) -> np.ndarray:
    """r uniform peers per owner (excluding the owner itself)."""
    n = len(indptr) - 1
    if n <= 1:
        return np.full((n, r), -1, np.int64)
    tab = np.empty((n, r), np.int64)
    for j in range(r):
        cand = rng.integers(0, n - 1, n)
        cand += cand >= np.arange(n)         # skip the owner's own id
        tab[:, j] = cand
    return tab


def _place_neighbor(indptr, indices, r: int, rng) -> np.ndarray:
    """r uniform NEIGHBORS per owner (isolated owners get no replicas)."""
    n = len(indptr) - 1
    deg = np.diff(indptr)
    tab = np.full((n, r), -1, np.int64)
    for j in range(r):
        raw = rng.integers(0, 1 << 62, n)
        sel = raw % np.maximum(deg, 1)
        tab[:, j] = np.where(deg > 0, indices[indptr[:-1] + sel], -1)
    return tab


register_placement("random", _place_random)
register_placement("neighbor", _place_neighbor)


def build_replica_table(indptr, indices, r: int,
                        placement: str) -> np.ndarray:
    """(n, r) replica peer ids per owner (-1 = unfilled slot).

    Deterministic in (overlay CSR, r, placement) — the scalar
    reference and the batched engines compute it from the same CSR
    arrays, so replication never enters the cross-backend parity story
    as anything but shared input data.
    """
    rng = np.random.default_rng(_PLACEMENT_STREAM + r)
    return get_placement(placement)(indptr, indices, r, rng)


def _serving_peers(owners: np.ndarray, replicas, death_row: np.ndarray,
                   t: float) -> np.ndarray:
    """Per owner: the peer that serves its items at time ``t`` — the
    owner itself when alive, else its first alive replica, else -1
    (items lost).  ``replicas`` is the (n, r) table or None."""
    served = np.where(death_row[owners] > t, owners, -1)
    if replicas is not None and replicas.shape[1] and len(owners):
        need = served < 0
        if need.any():
            reps = replicas[owners[need]]                   # (m, r)
            ok = (reps >= 0) & (death_row[np.maximum(reps, 0)] > t)
            has = ok.any(axis=1)
            first = reps[np.arange(len(reps)), ok.argmax(axis=1)]
            served[need] = np.where(has, first, -1)
    return served


# --------------------------------------------------------------------------
# forward-phase message counting
# --------------------------------------------------------------------------

def forward_messages(top: Topology, origin: int, parent, depth, reached,
                     strategy: str, p: SimParams,
                     rng: np.random.Generator,
                     child_allowed: Optional[np.ndarray] = None) -> int:
    """Count forward messages for basic / st1 / st1+2.

    ``child_allowed``: bool (n,) — statistics-heuristic pruning: peers a
    parent refuses to forward to (their subtree never receives Q) must be
    handled by the caller re-running bfs on the pruned graph; here it only
    restricts the counting.
    """
    n = top.n
    ttl = p.ttl
    ttl_rem = ttl - depth
    if strategy == "basic":
        m = 0
        for u in range(n):
            if not reached[u] or ttl_rem[u] <= 0:
                continue
            deg = len(top.neighbors[u])
            m += deg if u == origin else deg - 1
        return m
    # strategy 1 / 1+2: randomized λ per peer; send only to neighbors not
    # yet heard from
    lam = rng.random(n) * p.lam_max_s
    t_q = np.where(depth >= 0, depth * p.t_qsnd_s, np.inf)  # coarse arrival
    send_at = t_q + lam
    m = 0
    for u in range(n):
        if not reached[u] or ttl_rem[u] <= 0:
            continue
        pu = parent[u]
        plist: set = set()
        if strategy == "st1+2" and pu >= 0:
            plist = set(int(x) for x in top.neighbors[pu])
            plist.add(int(pu))
        for v in top.neighbors[u]:
            v = int(v)
            if v == pu:
                continue
            if not reached[v]:
                m += 1          # edge to a peer beyond TTL still costs
                continue
            if strategy == "st1+2" and v in plist:
                continue        # Strategy 2: v provably has Q already
            # Strategy 1: u sends unless it heard v's copy first
            if parent[v] == u:
                m += 1          # tree edge: u is v's first sender
            elif send_at[v] < send_at[u] and (parent[u] == v
                                              or depth[v] <= depth[u]):
                # v sent earlier and u would have received it: skip
                continue
            else:
                m += 1
    return m


# --------------------------------------------------------------------------
# full query simulation
# --------------------------------------------------------------------------

def run_query_reference(top: Topology, origin: int = 0,
                        params: Optional[SimParams] = None,
                        *, algorithm: str = "fd", strategy: str = "st1+2",
                        dynamic: bool = True,
                        lifetime_mean_s: float = float("inf"),
                        child_mask: Optional[np.ndarray] = None,
                        return_state: bool = False):
    """Simulate one Top-k query — the scalar REFERENCE implementation.

    The reference package's executable spec, copied line for line (it
    draws from ``np.random.default_rng(p.seed)`` in a fixed order): the
    batched draws below reproduce it bit for bit, and the two-round
    ``fd-stats`` heuristic (``SimEngine._run_stats``) runs it twice.
    Returns QueryMetrics (+ state dict).

    algorithm: "fd" | "cn" | "cn_star".
    strategy (fd): "basic" | "st1" | "st1+2" (forward-phase counting).
    dynamic (fd): urgent score-lists + rerouting (§4) on/off.
    child_mask: bool (n,) — peers excluded from forwarding (statistics
    heuristic §3.3); excluded subtrees never receive Q.
    """
    p = params if params is not None else SimParams()
    edge_lat = _latency_mode(top, p)
    rng = np.random.default_rng(p.seed)
    n = top.n
    pre_bfs = None
    if p.ttl == 0:
        if child_mask is None:
            # auto TTL = eccentricity: the full-depth BFS *is* the
            # TTL-limited BFS at that TTL, so resolve and reuse in one pass
            pre_bfs = bfs_tree(top, origin, n)
            p = dataclasses.replace(p, ttl=int(pre_bfs[1].max()))
        else:
            from repro_torch.p2psim.graph import eccentricity_ttl
            p = dataclasses.replace(p, ttl=eccentricity_ttl(top, origin))

    # ---- reach set (optionally pruned) ---------------------------------
    if child_mask is not None:
        pruned = Topology(n, [top.neighbors[u][child_mask[top.neighbors[u]]]
                              if child_mask[u] or u == origin
                              else np.array([], np.int32)
                              for u in range(n)], top.kind)
        parent, depth, reached = bfs_tree(pruned, origin, p.ttl)
        count_top = pruned
    else:
        parent, depth, reached = (pre_bfs if pre_bfs is not None
                                  else bfs_tree(top, origin, p.ttl))
        count_top = top
    idx = np.flatnonzero(reached)
    n_r = len(idx)
    ttl_rem = np.maximum(p.ttl - depth, 0)

    # ---- local data ----------------------------------------------------
    n_tuples = rng.integers(p.tuples_lo, p.tuples_hi + 1, n)
    scores = local_topk_scores(n_tuples, p.k, rng)          # (n, k)
    t_exec = n_tuples * p.exec_s_per_tuple

    # ---- per-edge link draws (tree edges) ------------------------------
    if edge_lat:
        # BRITE distance-proportional latency: deterministic per edge
        # and symmetric (one physical link), bandwidth still drawn per
        # direction in the iid draw's stream positions
        par_lat = _tree_edge_latency(top, parent)
        lat_up, bw_up = par_lat, _draw_bw(rng, p, n)   # v -> parent(v)
        lat_dn, bw_dn = par_lat, _draw_bw(rng, p, n)   # parent(v) -> v
    else:
        lat_up, bw_up = _draw_link(rng, p, n)   # v -> parent(v)
        lat_dn, bw_dn = _draw_link(rng, p, n)   # parent(v) -> v

    # query arrival times down the tree
    t_q = np.full(n, np.inf)
    t_q[origin] = 0.0
    order = idx[np.argsort(depth[idx])]
    for v in order:
        if v == origin:
            continue
        t_q[v] = t_q[parent[v]] + _link_time(QUERY_BYTES, lat_dn[v], bw_dn[v])
    t_ex_done = t_q + t_exec

    # ---- churn ----------------------------------------------------------
    if math.isinf(lifetime_mean_s):
        death = np.full(n, np.inf)
    else:
        death = rng.exponential(lifetime_mean_s, n)
        death[origin] = np.inf

    met = QueryMetrics(algorithm=algorithm)
    met.n_reached = n_r
    sub = set(int(i) for i in idx)
    met.n_edges_pq = sum(
        1 for u in idx for v in top.neighbors[u] if u < v and int(v) in sub)
    met.avg_degree = float(np.mean([len(top.neighbors[u]) for u in idx]))

    list_bytes = p.k * ENTRY_BYTES_PAPER
    item_sizes = np.maximum(
        rng.normal(p.item_mean_B, p.item_std_B, (n, p.k)), 64.0)

    # ---- CN / CN* baselines --------------------------------------------
    if algorithm in ("cn", "cn_star"):
        if edge_lat:
            # direct originator links: embedding distance origin -> v
            lat_o = top.pair_latency(origin, np.arange(n))
            bw_o = _draw_bw(rng, p, n)
        else:
            lat_o, bw_o = _draw_link(rng, p, n)
        per_peer = (item_sizes[:, :p.k].sum(1) if algorithm == "cn"
                    else np.full(n, float(list_bytes)))
        alive = death > t_ex_done
        senders = idx[alive[idx]]
        senders = senders[senders != origin]
        met.m_fw = forward_messages(count_top, origin, parent, depth,
                                    reached, "basic", p, rng)
        met.b_fw = met.m_fw * QUERY_BYTES
        met.m_bw = len(senders)
        met.b_bw = int(per_peer[senders].sum())
        # originator bandwidth contention: serialized arrival
        own_bw = max(p.bw_mean_Bps, 1.0)
        t_arrive = t_ex_done[senders] + lat_o[senders]
        t_resp = (np.max(t_arrive) if len(senders) else 0.0) \
            + per_peer[senders].sum() / own_bw
        if algorithm == "cn_star":
            # retrieval of actual items still needed
            true_full = np.full((n, p.k), -np.inf)
            true_full[idx] = scores[idx]
            flat = true_full.reshape(-1)
            top_idx = np.argpartition(flat, -p.k)[-p.k:]
            owners = np.unique(top_idx // p.k)
            met.m_rt = 2 * len(owners)
            met.b_rt = int(met.m_rt / 2 * p.request_B
                           + item_sizes.reshape(-1)[top_idx].sum())
            t_resp += 2 * p.latency_mean_s + met.b_rt / own_bw
        met.response_time_s = float(t_resp)
        delivered = np.zeros(n, bool)
        delivered[senders] = True
        delivered[origin] = True
        met.accuracy = _accuracy(scores, idx, delivered, p.k)
        return (met, None) if not return_state else (met, {
            "parent": parent, "depth": depth, "reached": reached})

    # ---- FD: merge-and-backward ----------------------------------------
    met.m_fw = forward_messages(count_top, origin, parent, depth, reached,
                                strategy, p, rng)
    met.b_fw = met.m_fw * QUERY_BYTES

    deadline = t_q + wait_time(ttl_rem, p)
    children: list = [[] for _ in range(n)]
    for v in idx:
        if parent[v] >= 0:
            children[parent[v]].append(int(v))

    # bottom-up: actual send time, delivered lists, merged content
    send_t = np.zeros(n)
    merged_scores = [None] * n       # (k,) arrays
    merged_owner = [None] * n
    delivered = np.zeros(n, bool)    # peer's own top-k reached its parent
    late_urgent: list = []           # (arrival_at_origin_estimate, peer)

    for v in order[::-1]:
        ch = children[v]
        arrivals = []
        for c in ch:
            a = send_t[c] + _link_time(list_bytes, lat_up[c], bw_up[c])
            arrivals.append((a, c))
        own_ready = t_ex_done[v]
        all_in = max([a for a, _ in arrivals], default=0.0)
        s = min(max(own_ready, all_in), max(deadline[v], own_ready))
        if death[v] < s:
            # peer left before sending: its subtree's merged list is lost
            # unless dynamic rerouting saves the CHILDREN's lists (they
            # reroute around the dead parent, §4.2)
            send_t[v] = np.inf
            merged_scores[v] = None
            continue
        send_t[v] = s
        # merge own + children lists that arrived in time (or urgent)
        mats = [scores[v]]
        owners = [np.full(p.k, v, dtype=np.int64)]
        for a, c in arrivals:
            if merged_scores[c] is None:
                # dead child subtree
                if dynamic:
                    for cc in children[c]:
                        if merged_scores[cc] is not None and \
                                send_t[cc] < np.inf:
                            mats.append(merged_scores[cc])
                            owners.append(merged_owner[cc])
                            met.m_bw += 1
                            met.b_bw += list_bytes
                continue
            if a <= s:
                mats.append(merged_scores[c])
                owners.append(merged_owner[c])
            else:
                if dynamic:
                    # urgent list: bubbles without wait; reaches origin
                    hops = depth[v]
                    eta = a + hops * (p.latency_mean_s
                                      + list_bytes / p.bw_mean_Bps)
                    late_urgent.append((eta, c))
                    met.m_bw += int(hops)
                    met.b_bw += int(hops) * list_bytes
        allm = np.concatenate(mats)
        allo = np.concatenate(owners)
        sel = np.argsort(allm)[::-1][:p.k]
        merged_scores[v] = allm[sel]
        merged_owner[v] = allo[sel]
        if v != origin:
            met.m_bw += 1
            met.b_bw += list_bytes

    # urgent lists accepted if they arrive before retrieval starts
    t_merge_done = send_t[origin] + p.merge_s
    extra = []
    for eta, c in late_urgent:
        if eta <= t_merge_done and merged_scores[c] is not None:
            extra.append((merged_scores[c], merged_owner[c]))
    if extra and merged_scores[origin] is not None:
        allm = np.concatenate([merged_scores[origin]]
                              + [e[0] for e in extra])
        allo = np.concatenate([merged_owner[origin]]
                              + [e[1] for e in extra])
        sel = np.argsort(allm)[::-1][:p.k]
        merged_scores[origin] = allm[sel]
        merged_owner[origin] = allo[sel]

    # ---- data retrieval --------------------------------------------------
    # a dead owner's items are fetched from its first alive replica
    # (replication_factor > 0); `served[i]` is the peer that serves
    # final owner i's items, or -1 when owner and all replicas are gone
    final_owners = np.unique(merged_owner[origin])
    replicas = None
    if p.replication_factor > 0:
        ip_, ix_ = as_csr(top)
        replicas = build_replica_table(ip_, ix_, p.replication_factor,
                                       p.replication_placement)
    served = _serving_peers(final_owners, replicas, death, t_merge_done)
    srv = served >= 0
    met.m_rt = 2 * int(srv.sum())
    if edge_lat:
        lat_o = top.pair_latency(origin,
                                 np.where(srv, served, final_owners))
        bw_o = _draw_bw(rng, p, len(final_owners))
    else:
        lat_o, bw_o = _draw_link(rng, p, len(final_owners))
    per_owner_counts = np.array(
        [(merged_owner[origin] == o).sum() for o in final_owners])
    fetch_bytes = per_owner_counts * p.item_mean_B
    met.b_rt = int(srv.sum() * p.request_B + fetch_bytes[srv].sum())
    t_fetch = (2 * lat_o + (p.request_B + fetch_bytes) / bw_o)
    t_fetch = t_fetch[srv]
    met.response_time_s = float(
        t_merge_done + (t_fetch.max() if len(t_fetch) else 0.0))

    # ---- accuracy ---------------------------------------------------------
    # delivered set: owners present in the final list are by construction
    # delivered; accuracy compares final list vs true top-k of reached set
    true_scores = scores[idx].reshape(-1)
    top_true = np.sort(true_scores)[::-1][:p.k]
    got = np.sort(merged_scores[origin])[::-1]
    # intersection by value (scores a.s. distinct)
    inter = np.intersect1d(top_true, got).size
    # retrieval failures (owner + every replica dead) lose their items
    lost_owned = np.isin(merged_owner[origin], final_owners[~srv])
    inter = max(0, inter - int(np.isin(
        merged_scores[origin][lost_owned], top_true).sum()))
    met.accuracy = inter / p.k

    state = {"parent": parent, "depth": depth, "reached": reached,
             "merged_scores": merged_scores, "merged_owner": merged_owner,
             "children": children, "scores": scores}
    return (met, state) if return_state else (met, None)


def _legacy_gate(message: str) -> None:
    """Retired-shim gate: raise, unless ``REPRO_LEGACY_API=1`` opts back
    into the old (warn-and-delegate) behavior for one more release."""
    if os.environ.get("REPRO_LEGACY_API") == "1":
        warnings.warn(message, DeprecationWarning, stacklevel=3)
        return
    raise RuntimeError(
        f"{message} (the legacy entrypoints are retired; set "
        "REPRO_LEGACY_API=1 to temporarily re-enable them)")


def run_query(top: Topology, origin: int = 0,
              params: Optional[SimParams] = None,
              *, algorithm: str = "fd", strategy: str = "st1+2",
              dynamic: bool = True, lifetime_mean_s: float = float("inf"),
              child_mask: Optional[np.ndarray] = None,
              return_state: bool = False, device=None):
    """Simulate one Top-k query — thin shim over ``repro_torch.engine``.

    Kept for backward compatibility; ``repro_torch.engine.SimEngine`` is
    the entrypoint (and amortizes its compiled ``NetworkPlan`` across
    calls, which this per-call shim cannot).  Bit-for-bit equal to
    ``run_query_reference``.  The ``child_mask`` / ``return_state``
    variants carry per-node state the batch engine does not expose and
    run the reference directly.  ``device`` goes to the engine
    (``"cuda"`` by default).

    .. deprecated:: use ``repro_torch.engine.SimEngine`` with a
       ``QuerySpec`` (``SimEngine(top, params).run(QuerySpec(origins=
       (origin,)), policy)``) — see the README migration table.
    """
    _legacy_gate(
        "run_query is deprecated; use repro_torch.engine.SimEngine with a "
        "QuerySpec: SimEngine(top, params).run(QuerySpec(origins="
        "(origin,)), policy) — see the README migration table")
    if child_mask is not None or return_state:
        return run_query_reference(
            top, origin, params, algorithm=algorithm, strategy=strategy,
            dynamic=dynamic, lifetime_mean_s=lifetime_mean_s,
            child_mask=child_mask, return_state=return_state)
    from repro_torch.engine import QuerySpec, SimEngine, policy_from_legacy
    pol = policy_from_legacy(algorithm, strategy, dynamic, lifetime_mean_s)
    res = SimEngine(top, params, device=device).run(
        QuerySpec(origins=(int(origin),)), pol)
    return res.metrics.query_metrics(0, 0), None


# --------------------------------------------------------------------------
# batched draws and per-origin statics
# --------------------------------------------------------------------------
def _draw_link_batch(rngs, p: SimParams, size):
    pairs = [_draw_link(r, p, size) for r in rngs]
    return (np.stack([a for a, _ in pairs]),
            np.stack([b for _, b in pairs]))


def _draw_bw_batch(rngs, p: SimParams, size):
    return np.stack([_draw_bw(r, p, size) for r in rngs])


def _local_topk_scores_batch(n_tuples: np.ndarray, u: np.ndarray,
                             k: int) -> np.ndarray:
    """Batched ``local_topk_scores`` with pre-drawn uniforms u (T, n, k).

    Same per-element expressions as the scalar version — bit-for-bit."""
    T, n = n_tuples.shape
    out = np.empty((T, n, k))
    cur = np.ones((T, n))
    remaining = n_tuples.astype(np.float64)
    for j in range(k):
        cur = cur * u[:, :, j] ** (1.0 / np.maximum(remaining, 1.0))
        out[:, :, j] = cur
        remaining -= 1.0
    return out


def _local_topk_scores_batch_fast(n_tuples: np.ndarray, u: np.ndarray,
                                  k: int) -> np.ndarray:
    """Log-space form of the same order statistics: exp(Σ log(u_i)/rem_i).

    ~3× cheaper than the k pow passes; identical distribution but
    last-ulp different values — only used when entry-wise bit-parity
    with ``run_query`` is not required (shared-stream, E > 1)."""
    rem = np.maximum(n_tuples[..., None].astype(np.float64)
                     - np.arange(k), 1.0)
    out = np.log(u, out=u)                       # clobbers u (not reused)
    out /= rem
    np.cumsum(out, axis=2, out=out)
    return np.exp(out, out=out)


@dataclasses.dataclass
class EntryDraws:
    """Every per-entry RNG draw, in ``run_query_reference``'s exact order.

    Factored out of the numpy sweep so EVERY SimEngine backend consumes
    the same numpy-drawn arrays — backends may lower the sweeps to
    different hardware (see ``repro_torch.engine.sim_torch``), but the
    stochastic inputs are bit-for-bit identical, which is what makes
    cross-backend parity a pure statement about the sweep math.

    ``rngs`` is left positioned exactly after the last pre-retrieval
    draw, so the exact retrieval path can continue each entry's stream
    where the scalar reference would.
    """
    exact: bool
    rngs: list                            # per-entry generators (or [g]*E)
    n_tuples: np.ndarray                  # (E, n) int
    scores: np.ndarray                    # (E, n, k) descending
    t_exec: np.ndarray                    # (E, n)
    up_term: np.ndarray                   # (E, n) lat + L_k / bw, v->parent
    dn_term: np.ndarray                   # (E, n) lat + Q / bw,  parent->v
    death: np.ndarray                     # (E, n); inf without churn
    item_sizes: Optional[np.ndarray]      # (E, n, k); None on fd fast path
    lam: Optional[np.ndarray]             # (E, n) st1/st1+2 random wait
    lat_o: Optional[np.ndarray]           # (E, n) cn/cn* originator links
    bw_o: Optional[np.ndarray]
    # latency_model="edge" only: (E, n) embedding latency origin -> v,
    # consumed by the retrieval epilogues in place of the iid lat draw
    origin_lat: Optional[np.ndarray] = None


def _precompute_draws(ent_origin: np.ndarray, seeds, n: int, p: SimParams,
                      algorithm: str, fw_strategy: str,
                      lifetime_mean_s: float, independent: bool,
                      par_lat: Optional[np.ndarray] = None,
                      origin_lat: Optional[np.ndarray] = None
                      ) -> EntryDraws:
    """All pre-retrieval draws for a flattened (E,) entry batch.

    The order is ``run_query_reference``'s: n_tuples, score uniforms,
    upward link, downward link, churn deaths, item sizes, then the
    per-algorithm extras (cn originator links / st1 wait lambdas).

    The churn draws live here too: ``death`` (exponential residual
    lifetimes, origin clamped immortal) is the ONE stochastic input the
    whole §4 machinery — peer removal, urgent forwarding, dead-parent
    rerouting — hinges on, so every backend consumes the same numpy
    deaths and churn parity reduces to sweep math.  Rerouting itself is
    deterministic in the paper's model (children go to the grandparent),
    so no further draws are needed.

    ``par_lat`` / ``origin_lat`` (both (E, n)) switch the link draws to
    the ``latency_model="edge"`` regime: latencies are the given
    embedding-derived values (tree-edge and origin-pair respectively)
    and only bandwidths are drawn — with ``_draw_bw``, the exact stream
    the scalar reference consumes in that mode.  Both backends receive
    the resulting ``up_term`` / ``dn_term`` / ``lat_o`` unchanged, so
    the latency model never breaks cross-backend bit parity.
    """
    E = len(seeds)
    k = p.k
    list_bytes = k * ENTRY_BYTES_PAPER
    if independent:
        rngs = [np.random.default_rng(s) for s in seeds]
        n_tuples = np.stack([r.integers(p.tuples_lo, p.tuples_hi + 1, n)
                             for r in rngs])
        u = np.stack([r.random((n, k)) for r in rngs])
    else:
        g = np.random.default_rng(int(seeds[0]))
        rngs = [g] * E
        n_tuples = g.integers(p.tuples_lo, p.tuples_hi + 1, (E, n))
        u = g.random((E, n, k))
    exact = independent or E == 1
    scores = (_local_topk_scores_batch(n_tuples, u, k) if exact
              else _local_topk_scores_batch_fast(n_tuples, u, k))
    t_exec = n_tuples * p.exec_s_per_tuple
    if par_lat is not None:
        if independent:
            bw_up = _draw_bw_batch(rngs, p, n)
            bw_dn = _draw_bw_batch(rngs, p, n)
        else:
            bw_up = _draw_bw(g, p, (E, n))
            bw_dn = _draw_bw(g, p, (E, n))
        lat_up = lat_dn = par_lat
    elif independent:
        lat_up, bw_up = _draw_link_batch(rngs, p, n)
        lat_dn, bw_dn = _draw_link_batch(rngs, p, n)
    else:
        lat_up, bw_up = _draw_link(g, p, (E, n))
        lat_dn, bw_dn = _draw_link(g, p, (E, n))
    if math.isinf(lifetime_mean_s):
        death = np.full((E, n), np.inf)
    else:
        if independent:
            death = np.stack([r.exponential(lifetime_mean_s, n)
                              for r in rngs])
        else:
            death = g.exponential(lifetime_mean_s, (E, n))
        death[np.arange(E), ent_origin] = np.inf
    # FD never reads the item-size values — only their stream position
    # matters, and only for entry-wise parity (independent / E == 1)
    item_sizes = None
    if algorithm != "fd" or exact:
        if independent:
            item_sizes = np.stack([np.maximum(
                r.normal(p.item_mean_B, p.item_std_B, (n, k)), 64.0)
                for r in rngs])
        else:
            item_sizes = np.maximum(
                g.normal(p.item_mean_B, p.item_std_B, (E, n, k)), 64.0)
    lam = lat_o = bw_o = None
    if algorithm in ("cn", "cn_star"):
        if origin_lat is not None:
            lat_o = origin_lat
            bw_o = (_draw_bw_batch(rngs, p, n) if independent
                    else _draw_bw(g, p, (E, n)))
        elif independent:
            lat_o, bw_o = _draw_link_batch(rngs, p, n)
        else:
            lat_o, bw_o = _draw_link(g, p, (E, n))
    elif fw_strategy != "basic":
        if independent:
            lam = np.stack([r.random(n) for r in rngs]) * p.lam_max_s
        else:
            lam = g.random((E, n)) * p.lam_max_s
    return EntryDraws(
        exact=exact, rngs=rngs, n_tuples=n_tuples, scores=scores,
        t_exec=t_exec, up_term=lat_up + list_bytes / bw_up,
        dn_term=lat_dn + QUERY_BYTES / bw_dn, death=death,
        item_sizes=item_sizes, lam=lam, lat_o=lat_o, bw_o=bw_o,
        origin_lat=origin_lat)


class _OriginStatic:
    """Trial-independent per-origin state (shared by all trials).

    ``edge_lat`` — the plan's CSR-aligned per-edge latency array
    (present when the topology carries coordinates): gathered here into
    ``par_lat`` (each node's tree-edge latency, the deterministic half
    of the ``latency_model="edge"`` link draws) and complemented by
    ``origin_lat`` (embedding latency origin -> v for the direct
    retrieval / CN originator links).
    """

    def __init__(self, top: Topology, indptr, indices, e_src, e_dst,
                 edge_keys, degrees, origin: int, ttl: int,
                 fw_strategy: str, bfs=None, edge_lat=None):
        n = top.n
        if bfs is not None:           # precomputed by the multi-origin BFS
            parent, depth, reached = bfs[:3]
            rank = bfs[3] if len(bfs) > 3 else None
            self.ttl = int(depth.max()) if ttl == 0 else ttl
        elif ttl == 0:
            # auto TTL = eccentricity: the full-depth BFS *is* the
            # TTL-limited BFS at that TTL, so reuse it
            parent, depth, reached, rank = bfs_tree_csr(
                indptr, indices, origin, n, return_rank=True)
            self.ttl = int(depth.max())
        else:
            self.ttl = ttl
            parent, depth, reached, rank = bfs_tree_csr(
                indptr, indices, origin, self.ttl, return_rank=True)
        self.parent, self.depth, self.reached = parent, depth, reached
        # within-level discovery ranks: the first-touch certificate the
        # live-overlay tree patch compares claims with (None only when a
        # caller passed a rank-less bfs tuple; such statics fall back to
        # the full BFS on every sync)
        self.rank = rank
        self.origin = origin
        self.idx = np.flatnonzero(reached)
        self.ttl_rem = np.maximum(self.ttl - depth, 0)
        dmax = int(depth.max())
        self.levels = [np.flatnonzero(depth == d) for d in range(dmax + 1)]
        # children CSR: grouped by parent, ascending within each parent —
        # the order run_query builds its per-node lists in
        childs = self.idx[parent[self.idx] >= 0]
        par = parent[childs]
        ordk = np.argsort(par, kind="stable")
        self.kid_sorted = childs[ordk]
        self.kid_ptr = np.searchsorted(par[ordk], np.arange(n + 1))
        self.fw_strategy = fw_strategy
        self.refresh_edges(top, e_src, e_dst, edge_keys, degrees, edge_lat)

    def refresh_edges(self, top: Topology, e_src, e_dst, edge_keys,
                      degrees, edge_lat) -> None:
        """(Re)derive everything that reads the GLOBAL edge arrays.

        The BFS tree (``parent`` / ``depth`` / ``reached`` / levels /
        child CSR) only sees edges on the tree, but the forward-phase
        masks, message counts, and latency gathers see every edge —
        ``NetworkPlan.sync`` calls this after an edge delta that left
        this origin's BFS tree unchanged, instead of rebuilding the
        whole static."""
        n = top.n
        parent, depth, reached = self.parent, self.depth, self.reached
        origin = self.origin
        self.n_edges_pq = int(((e_src < e_dst) & reached[e_src]
                               & reached[e_dst]).sum())
        self.avg_degree = float(np.mean(degrees[self.idx]))

        # ---- per-edge latency gathers (latency_model="edge") -----------
        if edge_lat is not None:
            self.par_lat = np.full(n, top.lat_base_s)
            ch = self.idx[parent[self.idx] >= 0]
            pos = np.searchsorted(edge_keys, ch * n + parent[ch])
            self.par_lat[ch] = edge_lat[pos]
            self.origin_lat = top.pair_latency(origin, np.arange(n))
        else:
            self.par_lat = self.origin_lat = None

        # ---- forward-phase static masks --------------------------------
        mask_u = reached & (self.ttl_rem > 0)
        self.m_basic = int(degrees[mask_u].sum() - mask_u.sum()
                           + int(mask_u[origin]))
        fw_strategy = self.fw_strategy
        if fw_strategy == "basic":
            return
        pu_e = parent[e_src]
        active = reached[e_src] & (self.ttl_rem[e_src] > 0) & (e_dst != pu_e)
        unreach = active & ~reached[e_dst]
        rest = active & reached[e_dst]
        if fw_strategy == "st1+2" and len(edge_keys):
            # Strategy 2 skip: v already reached by parent(u)'s send —
            # membership test (parent(u), v) ∈ E via the sorted key array
            m2 = rest & (pu_e >= 0)
            key = pu_e * n + e_dst
            pos = np.minimum(np.searchsorted(edge_keys, key[m2]),
                             len(edge_keys) - 1)
            member = np.zeros(len(e_src), bool)
            member[m2] = edge_keys[pos] == key[m2]
            rest = rest & ~member
        tree = rest & (parent[e_dst] == e_src)
        self.fw_static = int(unreach.sum() + tree.sum())
        els = np.flatnonzero(rest & ~tree)
        self.fw_els_src = e_src[els]
        self.fw_els_dst = e_dst[els]
        self.fw_cond = ((parent[self.fw_els_src] == self.fw_els_dst)
                        | (depth[self.fw_els_dst]
                           <= depth[self.fw_els_src]))

    def _classify_edges(self, pos, e_src, e_dst, edge_keys, base,
                        parent, depth, reached, ttl_rem):
        """refresh_edges' per-edge pipeline on a POSITION SUBSET.

        Returns (u, v, unreach, tree, els) booleans per position —
        exactly what the full pass would compute for those edges, so
        the delta patch below can subtract old and add new
        contributions without touching the rest."""
        u = e_src[pos].astype(np.int64)
        v = e_dst[pos].astype(np.int64)
        pu = parent[u]
        active = reached[u] & (ttl_rem[u] > 0) & (v != pu)
        unreach = active & ~reached[v]
        rest = active & reached[v]
        if self.fw_strategy == "st1+2" and len(edge_keys):
            m2 = rest & (pu >= 0)
            key = pu * base + v
            p_ = np.minimum(np.searchsorted(edge_keys, key[m2]),
                            len(edge_keys) - 1)
            member = np.zeros(len(u), bool)
            member[m2] = edge_keys[p_] == key[m2]
            rest = rest & ~member
        tree = rest & (parent[v] == u)
        return u, v, unreach, tree, rest & ~tree

    @classmethod
    def patched(cls, old: "_OriginStatic", top: Topology, indptr,
                indices, e_src, e_dst, edge_keys, degrees,
                requested_ttl: int, bfs, edge_lat, old_csr, removed,
                added) -> Optional["_OriginStatic"]:
        """Incremental rebuild for a SMALL tree delta — the live-overlay
        fast path behind ``NetworkPlan.sync``.

        ``bfs`` is the freshly recomputed (parent, depth, reached) on
        the patched CSR; ``old_csr`` the pre-mutation
        ``(n, indptr, indices, e_src, e_dst, edge_keys)``; ``removed``
        / ``added`` the net undirected edge delta from the overlay
        journal.  Wherever old and new BFS trees are bit-identical the
        old static's compiled structure is adopted wholesale; only
        levels, child-CSR rows, and per-edge classifications the delta
        can reach are re-derived — including the Strategy-2 membership
        coupling (an edge (p, w) appearing or vanishing re-classifies
        edges (u, w) of p's tree children).  Returns None for large or
        structural deltas (resolved TTL moved, origin departed, diff
        beyond budget): the caller falls back to a full rebuild.  The
        result is field-for-field equal to a from-scratch
        ``_OriginStatic`` — asserted by tests/test_torch_overlay.py and
        by ``chip_smoke.py``'s live-overlay phase.
        """
        P, D, R = bfs[:3]
        K = bfs[3] if len(bfs) > 3 else None
        n = top.n
        old_n, old_indptr, old_indices, old_e_src, old_e_dst, old_keys \
            = old_csr
        resolved = int(D.max()) if requested_ttl == 0 else requested_ttl
        if old_n == n:
            op_, od_ = old.parent, old.depth
            or_, otr = old.reached, old.ttl_rem
        else:                     # peers joined: pad the old view
            pad = n - old_n
            op_ = np.concatenate([old.parent,
                                  np.full(pad, -1, old.parent.dtype)])
            od_ = np.concatenate([old.depth,
                                  np.full(pad, -1, old.depth.dtype)])
            or_ = np.concatenate([old.reached, np.zeros(pad, bool)])
            otr = np.maximum(old.ttl - od_, 0)
        diff = np.flatnonzero((op_ != P) | (od_ != D))
        # a moved resolved TTL shifts ttl_rem everywhere, but the edge
        # classification only reads it through ``ttl_rem[u] > 0`` — the
        # bit flips exactly for sources with depth in [min_ttl, max_ttl),
        # so re-deriving THEIR out-edges (old and new basis) absorbs an
        # eccentricity change without a full rebuild
        if resolved == old.ttl:
            tfl_old = tfl_new = np.zeros(0, np.int64)
        else:
            lo, hi = sorted((resolved, old.ttl))
            tfl_old = np.flatnonzero((od_ >= lo) & (od_ < hi))
            tfl_new = np.flatnonzero((D >= lo) & (D < hi))
        budget = 64 + n // 128
        if (len(diff) + len(tfl_old) + len(tfl_new) > budget
                or len(removed) + len(added) > budget):
            return None
        st = copy.copy(old)
        st.parent, st.depth, st.reached = P, D, R
        st.rank = K
        st.ttl = resolved
        st.idx = np.flatnonzero(R)
        st.ttl_rem = np.maximum(resolved - D, 0)

        # ---- levels: recompute only depths the diff touches ------------
        dmax = int(D.max())
        touched = ({int(x) for x in od_[diff]}
                   | {int(x) for x in D[diff]}) - {-1}
        old_dmax = len(old.levels) - 1
        st.levels = [old.levels[d]
                     if (d <= old_dmax and d not in touched)
                     else np.flatnonzero(D == d)
                     for d in range(dmax + 1)]

        # ---- children CSR: drop / re-insert only the diff nodes --------
        kid = old.kid_sorted
        gone = diff[(diff < old_n)]
        gone = gone[op_[gone] >= 0]
        if len(gone):
            kid = kid[~np.isin(kid, gone)]
        ins = diff[P[diff] >= 0]
        if len(ins):
            kk = P[kid] * np.int64(n) + kid
            ik = P[ins] * np.int64(n) + ins
            o_ = np.argsort(ik, kind="stable")
            kid = np.insert(kid, np.searchsorted(kk, ik[o_]), ins[o_])
        st.kid_sorted = kid
        kp = np.zeros(n + 1, old.kid_ptr.dtype)
        np.cumsum(np.bincount(P[kid], minlength=n), out=kp[1:])
        st.kid_ptr = kp

        # ---- affected directed-edge positions, old and new sides -------
        def out_in_pos(nodes, indptr, indices, keys, base):
            pos = [np.zeros(0, np.int64)]
            for x in nodes:
                lo, hi = int(indptr[x]), int(indptr[x + 1])
                pos.append(np.arange(lo, hi, dtype=np.int64))  # out-edges
                us = indices[lo:hi].astype(np.int64)           # in-edges
                pos.append(np.searchsorted(keys, us * base + x))
            return pos

        def pair_pos(pairs, keys, base, lim):
            out = [np.zeros(0, np.int64)]
            for a, b in pairs:
                if a >= lim or b >= lim:
                    continue
                k = np.array([a * base + b, b * base + a], np.int64)
                p_ = np.searchsorted(keys, k)
                ok = p_ < len(keys)
                p_, k = p_[ok], k[ok]
                out.append(p_[keys[p_] == k])
            return out

        # Strategy-2 coupling: delta edge (p, w) re-classifies (u, w)
        # for u in p's tree children (old AND new tree)
        coup = []
        if old.fw_strategy == "st1+2":
            for a, b in list(removed) + list(added):
                for p, w in ((a, b), (b, a)):
                    if p < old_n:
                        cs = old.kid_sorted[old.kid_ptr[p]:
                                            old.kid_ptr[p + 1]]
                        coup.extend((int(u), w) for u in cs)
                    cs = kid[kp[p]:kp[p + 1]]
                    coup.extend((int(u), w) for u in cs)
        diff_old = diff[diff < old_n]
        A_old = [*out_in_pos(diff_old, old_indptr, old_indices,
                             old_keys, old_n),
                 *out_in_pos(tfl_old[tfl_old < old_n], old_indptr,
                             old_indices, old_keys, old_n),
                 *pair_pos(list(removed) + coup, old_keys, old_n, old_n)]
        A_new = [*out_in_pos(diff, indptr, indices, edge_keys, n),
                 *out_in_pos(tfl_new, indptr, indices, edge_keys, n),
                 *pair_pos(list(added) + coup, edge_keys, n, n)]
        A_old = np.unique(np.concatenate(A_old))
        A_new = np.unique(np.concatenate(A_new))

        # ---- O(n)-cheap aggregates: recompute outright -----------------
        st.avg_degree = float(np.mean(degrees[st.idx]))
        mask_u = R & (st.ttl_rem > 0)
        st.m_basic = int(degrees[mask_u].sum() - mask_u.sum()
                         + int(mask_u[old.origin]))

        # ---- per-edge latency gathers ----------------------------------
        if edge_lat is not None:
            pl = (old.par_lat.copy() if old_n == n else np.concatenate(
                [old.par_lat, np.full(n - old_n, top.lat_base_s)]))
            pl[diff] = top.lat_base_s
            ch = diff[P[diff] >= 0]
            if len(ch):
                pos = np.searchsorted(edge_keys,
                                      ch * np.int64(n) + P[ch])
                pl[ch] = edge_lat[pos]
            st.par_lat = pl
            st.origin_lat = (old.origin_lat if old_n == n
                             else np.concatenate([
                                 old.origin_lat,
                                 top.pair_latency(old.origin,
                                                  np.arange(old_n, n))]))

        # ---- classify the affected edges, old vs new -------------------
        uo, vo, uno, tro, elo = old._classify_edges(
            A_old, old_e_src, old_e_dst, old_keys, old_n,
            op_, od_, or_, otr)
        un, vn, unn, trn, eln = st._classify_edges(
            A_new, e_src, e_dst, edge_keys, n, P, D, R, st.ttl_rem)
        mo, mn = uo < vo, un < vn
        st.n_edges_pq = (old.n_edges_pq
                         - int((or_[uo[mo]] & or_[vo[mo]]).sum())
                         + int((R[un[mn]] & R[vn[mn]]).sum()))
        if old.fw_strategy == "basic":
            return st
        st.fw_static = (old.fw_static - int(uno.sum() + tro.sum())
                        + int(unn.sum() + trn.sum()))
        # els content patch, (src, dst)-ascending order preserved:
        # every affected pair is dropped, then the still-els ones are
        # re-inserted at their sorted position with a fresh cond
        n64 = np.int64(n)
        ek = old.fw_els_src.astype(np.int64) * n64 + old.fw_els_dst
        keep = ~np.isin(ek, uo * n64 + vo)
        src = old.fw_els_src[keep]
        dst = old.fw_els_dst[keep]
        cond = old.fw_cond[keep]
        iu, iv = un[eln], vn[eln]
        if len(iu):
            ik = iu * n64 + iv
            o_ = np.argsort(ik, kind="stable")
            iu, iv, ik = iu[o_], iv[o_], ik[o_]
            p_ = np.searchsorted(ek[keep], ik)
            src = np.insert(src, p_, iu.astype(src.dtype))
            dst = np.insert(dst, p_, iv.astype(dst.dtype))
            cond = np.insert(cond, p_, (P[iu] == iv) | (D[iv] <= D[iu]))
        st.fw_els_src, st.fw_els_dst, st.fw_cond = src, dst, cond
        return st


# --------------------------------------------------------------------------
# the shared epilogue
# --------------------------------------------------------------------------
def _entry_latencies(sts, ent_st: np.ndarray, p: SimParams):
    """(par_lat, origin_lat) as (E, n) entry-expanded arrays, or (None,
    None) in the default iid model (backend-shared helper)."""
    if p.latency_model != "edge":
        return None, None
    if sts[0].par_lat is None:
        raise ValueError(
            "latency_model='edge' needs node coordinates; this "
            "topology has none (use a coordinate-carrying "
            "generator)")
    return (np.stack([st.par_lat for st in sts])[ent_st],
            np.stack([st.origin_lat for st in sts])[ent_st])


def _topk_remerge(mvals_row, mown_row, extra_v, extra_o, k):
    """Exact: top-k(top-k(A) ∪ B) == top-k(A ∪ B) for distinct values."""
    allm = np.concatenate([mvals_row] + extra_v)
    allo = np.concatenate([mown_row] + extra_o)
    sel = np.argsort(allm)[::-1][:k]
    return allm[sel], allo[sel]


def _empty_out(E: int, k: Optional[int] = None) -> dict:
    out = {f: np.zeros(E, np.int64)
           for f in ("m_fw", "m_bw", "m_rt", "b_bw", "b_rt")}
    out["response_time_s"] = np.zeros(E)
    out["accuracy"] = np.zeros(E)
    if k is not None:
        # the origin's merged k-list (descending values + owning peers)
        # — what the precision tolerance contract compares across runs
        out["values"] = np.full((E, k), -np.inf)
        out["owners"] = np.full((E, k), -1, np.int64)
    return out


def _accuracy(scores, idx, delivered, k) -> float:
    true_scores = scores[idx].reshape(-1)
    top_true = np.sort(true_scores)[::-1][:k]
    deliv_idx = idx[delivered[idx]]
    if len(deliv_idx) == 0:
        return 0.0
    got = np.sort(scores[deliv_idx].reshape(-1))[::-1][:k]
    return float(np.intersect1d(top_true, got).size) / k


def _cn_entries(out: dict, draws: EntryDraws, sts, ent_st: np.ndarray,
                ent_origin: np.ndarray, t_ex_done: np.ndarray,
                p: SimParams, algorithm: str) -> None:
    """CN / CN* baselines given arrival times (backend-shared)."""
    E = len(ent_st)
    k = p.k
    n = t_ex_done.shape[1]
    list_bytes = k * ENTRY_BYTES_PAPER
    scores, death = draws.scores, draws.death
    item_sizes, lat_o = draws.item_sizes, draws.lat_o
    for e in range(E):
        idx = sts[ent_st[e]].idx
        origin = int(ent_origin[e])
        per_peer = (item_sizes[e][:, :k].sum(1) if algorithm == "cn"
                    else np.full(n, float(list_bytes)))
        alive = death[e] > t_ex_done[e]
        senders = idx[alive[idx]]
        senders = senders[senders != origin]
        out["m_bw"][e] = len(senders)
        out["b_bw"][e] = int(per_peer[senders].sum())
        own_bw = max(p.bw_mean_Bps, 1.0)
        t_arrive = t_ex_done[e][senders] + lat_o[e][senders]
        t_resp = (np.max(t_arrive) if len(senders) else 0.0) \
            + per_peer[senders].sum() / own_bw
        if algorithm == "cn_star":
            true_full = np.full((n, k), -np.inf)
            true_full[idx] = scores[e][idx]
            flat = true_full.reshape(-1)
            top_idx = np.argpartition(flat, -k)[-k:]
            owners = np.unique(top_idx // k)
            out["m_rt"][e] = 2 * len(owners)
            out["b_rt"][e] = int(
                out["m_rt"][e] / 2 * p.request_B
                + item_sizes[e].reshape(-1)[top_idx].sum())
            t_resp += 2 * p.latency_mean_s + out["b_rt"][e] / own_bw
        out["response_time_s"][e] = float(t_resp)
        delivered = np.zeros(n, bool)
        delivered[senders] = True
        delivered[origin] = True
        out["accuracy"][e] = _accuracy(scores[e], idx, delivered, k)
        if "values" in out:
            # the origin's collected k-list: top-k over every delivered
            # peer's items (the origin always delivers to itself)
            didx = idx[delivered[idx]]
            sc = scores[e][didx].reshape(-1)
            top = np.argpartition(sc, -k)[-k:]
            top = top[np.argsort(sc[top])[::-1]]
            out["values"][e] = sc[top]
            out["owners"][e] = didx[top // k]


def _true_topk_by_origin(scores: np.ndarray, sts, ent_of_st,
                         k: int) -> np.ndarray:
    """(E, k) true top-k of each entry's reach set, grouped by origin."""
    E = scores.shape[0]
    top_true_all = np.empty((E, k))
    for s, st in enumerate(sts):
        es = ent_of_st[s]
        block = scores[np.ix_(es, st.idx)].reshape(len(es), -1)
        part = np.partition(block, -k, axis=1)[:, -k:]
        top_true_all[es] = np.sort(part, axis=1)[:, ::-1]
    return top_true_all


def _reroute_counts(st, valid_rows: np.ndarray) -> np.ndarray:
    """Per-entry count of §4.2 dead-parent reroutes (backend-shared).

    A reroute message is sent per grandchild ``cc`` whose parent died
    before its send time while both ``cc`` and the grandparent survive
    — exactly the lists the numpy sweep re-merges and the jax sweep's
    masked reroute fold accepts.  ``valid_rows``: (entries, n) liveness
    (True = alive at its send time) for this origin's entries.
    """
    ch = st.kid_sorted
    pr = st.parent[ch]
    has_gp = st.parent[pr] >= 0
    cc, pp = ch[has_gp], pr[has_gp]
    gp = st.parent[pp]
    return (valid_rows[:, cc] & ~valid_rows[:, pp]
            & valid_rows[:, gp]).sum(axis=1)


def _accept_urgent_origin(urgent, ent_origin: np.ndarray,
                          t_merge_done: np.ndarray, mvals: np.ndarray,
                          mown: np.ndarray, valid: Optional[np.ndarray],
                          k: int) -> None:
    """Fold urgent lists arriving before retrieval into the origin's
    merge (``valid`` is None when churn is off — everyone is alive)."""
    for e in range(len(ent_origin)):
        if not urgent[e]:
            continue
        origin = int(ent_origin[e])
        ok = [c for (eta, c) in urgent[e]
              if eta <= t_merge_done[e]
              and (valid is None or valid[e, c])]
        if ok and (valid is None or valid[e, origin]):
            mvals[e, origin], mown[e, origin] = _topk_remerge(
                mvals[e, origin], mown[e, origin],
                [mvals[e, c] for c in ok], [mown[e, c] for c in ok], k)


def _retrieval_exact(out: dict, draws: EntryDraws, ent_origin: np.ndarray,
                     t_merge_done: np.ndarray, mvals: np.ndarray,
                     mown: np.ndarray, top_true_all: np.ndarray,
                     p: SimParams, replicas=None) -> None:
    """run_query's per-entry retrieval, verbatim (bit-for-bit parity).

    ``replicas`` — the plan's (n, r) placement table (None = replication
    off): a dead owner's items are served by its first alive replica,
    exactly the scalar reference's fallback."""
    k = p.k
    death, rngs = draws.death, draws.rngs
    for e in range(len(ent_origin)):
        origin = int(ent_origin[e])
        final_owners = np.unique(mown[e, origin])
        served = _serving_peers(final_owners, replicas, death[e],
                                t_merge_done[e])
        srv = served >= 0
        out["m_rt"][e] = 2 * int(srv.sum())
        if draws.origin_lat is None:
            lat_o, bw_o = _draw_link(rngs[e], p, len(final_owners))
        else:
            lat_o = draws.origin_lat[
                e, np.where(srv, served, final_owners)]
            bw_o = _draw_bw(rngs[e], p, len(final_owners))
        per_owner_counts = np.array(
            [(mown[e, origin] == o).sum() for o in final_owners])
        fetch_bytes = per_owner_counts * p.item_mean_B
        out["b_rt"][e] = int(srv.sum() * p.request_B
                             + fetch_bytes[srv].sum())
        t_fetch = (2 * lat_o + (p.request_B + fetch_bytes) / bw_o)
        t_fetch = t_fetch[srv]
        out["response_time_s"][e] = float(
            t_merge_done[e] + (t_fetch.max() if len(t_fetch) else 0.0))

        got = mvals[e, origin]              # sorted descending
        inter = np.intersect1d(top_true_all[e], got).size
        lost_owned = np.isin(mown[e, origin], final_owners[~srv])
        inter = max(0, inter - int(np.isin(
            mvals[e, origin][lost_owned], top_true_all[e]).sum()))
        out["accuracy"][e] = inter / k


def _retrieval_shared(out: dict, draws: EntryDraws,
                      ent_origin: np.ndarray, t_merge_done: np.ndarray,
                      mvals: np.ndarray, mown: np.ndarray,
                      top_true_all: np.ndarray, p: SimParams,
                      replicas=None) -> None:
    """Shared-stream fast path: the same retrieval model, vectorized over
    all entries at once (draw assignment to owners differs but is
    i.i.d. — distributionally identical to the scalar path).

    ``replicas`` — (n, r) placement table (None = replication off): a
    dead owner's items are served by its first alive replica.  With
    ``replicas=None`` every expression below reduces bit-for-bit to the
    replication-free code (``served == mo`` wherever it is read)."""
    E = len(ent_origin)
    k = p.k
    death = draws.death
    ar = np.arange(E)
    mo = mown[ar, ent_origin]                                # (E, k)
    gv = mvals[ar, ent_origin]                               # (E, k)
    dth = death[ar[:, None], mo]                             # (E, k)
    alive_elem = dth > t_merge_done[:, None]
    if replicas is None or replicas.shape[1] == 0:
        served = np.where(alive_elem, mo, -1)
    else:
        rep = replicas[np.maximum(mo, 0)]                    # (E, k, r)
        rep_ok = (rep >= 0) & (death[ar[:, None, None],
                                     np.maximum(rep, 0)]
                               > t_merge_done[:, None, None])
        first = np.take_along_axis(
            rep, rep_ok.argmax(axis=2)[..., None], axis=2)[..., 0]
        served = np.where(alive_elem, mo,
                          np.where(rep_ok.any(axis=2) & (mo >= 0),
                                   first, -1))
    srv_elem = served >= 0
    eqm = mo[:, :, None] == mo[:, None, :]                   # (E, k, k)
    count_elem = eqm.sum(axis=2)                 # owner multiplicity
    firstocc = ~(eqm & np.tri(k, k, -1, dtype=bool)[None]).any(axis=2)
    srv_owner_cnt = (firstocc & srv_elem).sum(axis=1)
    out["m_rt"][:] = 2 * srv_owner_cnt
    # Σ_over-served-owners count_o · item_mean == #elements with a
    # serving peer · item_mean (exact: every term is an integer multiple)
    fetch_total = srv_elem.sum(axis=1) * p.item_mean_B
    out["b_rt"][:] = (srv_owner_cnt * p.request_B
                      + fetch_total).astype(np.int64)
    if draws.origin_lat is None:
        lat_o, bw_o = _draw_link(draws.rngs[0], p, (E, k))  # per owner slot
    else:            # edge model: serving-peer latency deterministic
        lat_o = draws.origin_lat[ar[:, None],
                                 np.where(srv_elem, served, mo)]
        bw_o = _draw_bw(draws.rngs[0], p, (E, k))
    t_f = 2 * lat_o + (p.request_B + count_elem * p.item_mean_B) / bw_o
    t_max = np.where(firstocc & srv_elem, t_f, -np.inf).max(axis=1)
    out["response_time_s"][:] = t_merge_done + np.where(
        np.isfinite(t_max), t_max, 0.0)

    match = (gv[:, :, None] == top_true_all[:, None, :]).any(axis=2)
    inter = match.sum(axis=1)
    corr = (match & ~srv_elem).sum(axis=1)
    out["accuracy"][:] = np.maximum(0, inter - corr) / k


def run_queries(top: Topology, origins,
                params: Optional[SimParams] = None,
                n_trials: int = 1, *, algorithm: str = "fd",
                strategy: str = "st1+2", dynamic: bool = True,
                lifetime_mean_s: float = float("inf"),
                seeds=None, independent_streams: bool = False,
                device=None) -> BatchMetrics:
    """Batched multi-query simulation — thin shim over
    ``repro_torch.engine``.

    Evaluates (len(origins) × n_trials) queries in one call; see
    ``repro_torch.engine.SimEngine`` (the entrypoint, which additionally
    caches the compiled ``NetworkPlan`` across calls) for the execution
    model, and ``QuerySpec`` for the RNG modes:

      * default (shared stream) — one generator seeded ``params.seed``
        issues batch-shaped draws; a batch of ONE reproduces
        ``run_query`` bit-for-bit, larger batches are i.i.d.;
      * ``independent_streams=True`` (implied by passing ``seeds``) —
        entry (q, t) reproduces ``run_query`` with seed
        ``params.seed + q * n_trials + t`` (or ``seeds[q, t]``)
        bit-for-bit, entry by entry.

    ``device`` goes to the engine (``"cuda"`` by default).

    .. deprecated:: use ``repro_torch.engine.SimEngine`` with a
       ``QuerySpec`` (``QuerySpec(origins=origins, n_trials=n_trials,
       rng="independent")``) — see the README migration table.
    """
    _legacy_gate(
        "run_queries is deprecated; use repro_torch.engine.SimEngine with "
        "a QuerySpec(origins=..., n_trials=..., rng=...) — see the README "
        "migration table")
    from repro_torch.engine import QuerySpec, SimEngine, policy_from_legacy
    pol = policy_from_legacy(algorithm, strategy, dynamic, lifetime_mean_s)
    spec = QuerySpec(
        origins=tuple(int(o) for o in np.atleast_1d(np.asarray(origins))),
        n_trials=n_trials, seeds=seeds,
        rng="independent" if independent_streams else "shared")
    return SimEngine(top, params, device=device).run(spec, pol).metrics


def run_statistics_heuristic(top: Topology, origin: int,
                             params: SimParams, z: float, *, device=None):
    """Two-round statistics heuristic — thin shim over the engine's
    ``"fd-stats"`` policy (see ``SimEngine._run_stats``): round 1 full
    FD gathers per-child best-rank stats; round 2 forwards Q only to
    children whose best past score ranked above z*k in the parent's
    merged list.  Returns (metrics_full, metrics_pruned,
    comm_reduction, accuracy).  ``device`` goes to the engine
    (``"cuda"`` by default), though both rounds run on the host.

    .. deprecated:: use ``repro_torch.engine.SimEngine`` with the
       ``"fd-stats"`` policy (``get_policy("fd-stats").variant(z=z)``;
       rounds land in ``TopKResult.extras``) — see the README migration
       table.
    """
    _legacy_gate(
        "run_statistics_heuristic is deprecated; use repro_torch.engine."
        "SimEngine with get_policy('fd-stats').variant(z=z) — rounds "
        "land in TopKResult.extras; see the README migration table")
    from repro_torch.engine import QuerySpec, SimEngine, get_policy
    res = SimEngine(top, params, device=device).run(
        QuerySpec(origins=(int(origin),)),
        get_policy("fd-stats").variant(z=z))
    ex = res.extras
    return (ex["metrics_full"], ex["metrics_pruned"],
            ex["comm_reduction"], ex["accuracy"])
