"""Live overlays in the port on the CPU, against the reference package,
bit for bit.

Mirrors tests/test_overlay.py: the same op stream is applied to a
reference ``repro.p2psim.overlay.Overlay`` and to the port's
``Overlay`` (built from the same arrays with ``topology_from_arrays``);
the journals, versions, adjacency and event lists agree; and every
answer the port serves from a synced plan (``SimEngine(device="cpu")``)
equals, in float64 bits (``values``, ``indices`` and every
``BatchMetrics`` field), the port's answer from a plan rebuilt from
scratch and the reference numpy ``SimEngine``'s on its own synced plan:
static, churn (finite lifetime) and CN, in the shared and independent
RNG modes.

Port-specific: the port's ``_patch_tree`` and ``_OriginStatic.patched``
return what the reference's return on the same inputs (None where it
does); ``DepthSlices(reuse=...)`` adopts the same levels as the
reference's, with equal level dicts; after a rewire that leaves a tree
intact the device copies of the slices (``sim_torch._device_slices``)
carry the new Strategy-1 edge arrays; a request from a tombstoned
origin; and a ``QueryServer`` over an overlay-bound engine, mutated
between drained batches.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.engine as ref_engine
import repro.engine.plan as ref_planmod
import repro.p2psim.overlay as ref_overlay
from repro.engine.plan import NetworkPlan as RefPlan
from repro.p2psim import SimParams as RefParams
from repro.p2psim import barabasi_albert as ref_ba
from repro.p2psim import waxman as ref_waxman
from repro.p2psim.graph import Topology as RefTopology
from repro.p2psim.simulate import _OriginStatic as RefStatic
import repro_torch.engine.plan as planmod
from repro_torch.engine import (NetworkPlan, Overlay, QueryServer, QuerySpec,
                                SessionEvent, SimEngine, apply_events,
                                get_policy, random_session, registry)
from repro_torch.engine.plan import DepthSlices
from repro_torch.engine.sim_torch import _device_slices
from repro_torch.p2psim import SimParams, topology_from_arrays
from repro_torch.p2psim.graph import bfs_tree, eccentricity_ttl
from repro_torch.p2psim.simulate import _OriginStatic, run_query_reference

FIELDS = ("n_reached", "n_edges_pq", "avg_degree", "m_fw", "b_fw", "m_bw",
          "m_rt", "b_bw", "b_rt", "response_time_s", "accuracy")
REF_PA = RefParams(seed=11)
PA = SimParams(**dataclasses.asdict(REF_PA))
LIFETIME = 30.0
STATIC_FIELDS = ("parent", "depth", "reached", "rank", "idx", "ttl_rem",
                 "kid_sorted", "kid_ptr", "ttl", "n_edges_pq", "avg_degree",
                 "m_basic", "fw_static", "fw_els_src", "fw_els_dst",
                 "fw_cond", "par_lat", "origin_lat")
CPU = torch.device("cpu")


def _path(n):
    nb = [np.array([v for v in (u - 1, u + 1) if 0 <= v < n], np.int32)
          for u in range(n)]
    return RefTopology(n=n, neighbors=nb, kind="path")


def _pair(ref_top):
    """The reference overlay of ``ref_top`` and the port's, built from the
    same arrays."""
    top = topology_from_arrays(ref_top.n, ref_top.neighbors, ref_top.kind,
                               ref_top.coords)
    return ref_overlay.Overlay(ref_top), Overlay(top)


def _engines(ref_top, params=None):
    """(reference overlay, port overlay, reference engine, port engine),
    each engine bound to its own overlay."""
    rov, ov = _pair(ref_top)
    p = PA if params is None else params
    rp = RefParams(**dataclasses.asdict(p))
    return (rov, ov, ref_engine.SimEngine(rov, rp),
            SimEngine(ov, p, device="cpu"))


def _assert_same_overlay(rov, ov):
    assert (ov.version, ov.n) == (rov.version, rov.n)
    assert ([dataclasses.astuple(d) for d in ov.deltas_since(0)]
            == [dataclasses.astuple(d) for d in rov.deltas_since(0)])
    for a, b in zip(ov.top.neighbors, rov.top.neighbors):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    if rov.top.coords is None:
        assert ov.top.coords is None
    else:
        assert np.array_equal(ov.top.coords, rov.top.coords)


def _both(rov, ov, fn):
    """Apply the op stream ``fn`` to both overlays; their results agree."""
    got, want = fn(ov), fn(rov)
    if isinstance(want, np.ndarray):
        assert np.array_equal(got, want)
    else:
        assert got == want
    _assert_same_overlay(rov, ov)
    return got


def _same_bits(port, ref, ctx):
    assert port.backend_used == "sim-torch", ctx
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port.metrics, f),
                                      getattr(ref.metrics, f),
                                      err_msg=f"{ctx}: {f}")
    if ref.values is not None:
        np.testing.assert_array_equal(port.values, ref.values,
                                      err_msg=f"{ctx}: values")
        np.testing.assert_array_equal(port.indices, ref.indices,
                                      err_msg=f"{ctx}: indices")


def _ref_spec(spec):
    return ref_engine.QuerySpec(**{f.name: getattr(spec, f.name)
                                   for f in dataclasses.fields(spec)})


def _policies(lifetime):
    """(name, port policy, reference policy): static, churn and CN."""
    out = [("fd-dynamic", get_policy("fd-dynamic"),
            ref_engine.get_policy("fd-dynamic")),
           ("cn", get_policy("cn"), ref_engine.get_policy("cn"))]
    if lifetime != float("inf"):
        out.append((f"fd-dynamic@{lifetime:g}",
                    get_policy("fd-dynamic").variant(
                        lifetime_mean_s=lifetime),
                    ref_engine.get_policy("fd-dynamic").variant(
                        lifetime_mean_s=lifetime)))
    return out


def _assert_plans_agree(eng, ref_eng, origins, *, lifetime=LIFETIME,
                        modes=("shared", "independent"),
                        latency_models=("iid",)):
    """The port engine's answers on its synced plan == a port engine on a
    from-scratch plan == the reference engine on its synced plan, and a
    shared batch-of-1 == the scalar reference run."""
    fresh = SimEngine(NetworkPlan(eng.plan.top), eng.params, device="cpu")
    for lm in latency_models:
        for rng in modes:
            spec = QuerySpec(origins=tuple(origins), n_trials=2, rng=rng,
                             latency_model=lm)
            for name, pol, ref_pol in _policies(lifetime):
                got = eng.run(spec, pol)
                ctx = f"{name} {rng} {lm}"
                _same_bits(got, fresh.run(spec, pol), ctx + " vs rebuild")
                _same_bits(got, ref_eng.run(_ref_spec(spec), ref_pol),
                           ctx + " vs reference")
    assert eng.plan.version == eng.plan.overlay.version
    o = int(origins[0])
    ref, _ = run_query_reference(eng.plan.top, o, eng.params, dynamic=True,
                                 lifetime_mean_s=lifetime)
    pol = get_policy("fd-dynamic").variant(lifetime_mean_s=lifetime)
    assert eng.run(QuerySpec(origins=(o,)), pol).query_metrics(0, 0) == ref


# --------------------------------------------------------------------------
# the Overlay mutation API
# --------------------------------------------------------------------------

def test_overlay_mutations_version_and_journal():
    ref_top = ref_ba(40, m=2, seed=1)
    rov, ov = _pair(ref_top)
    assert ov.version == 0 and ov.n == 40
    former = _both(rov, ov, lambda o: o.remove_peer(7))
    assert ov.degree(7) == 0 and len(former) > 0
    assert all(not ov.has_edge(7, int(v)) for v in former)
    pid = _both(rov, ov, lambda o: o.add_peer(neighbors=(0, 3)))
    assert pid == 40 and ov.n == 41
    assert ov.has_edge(pid, 0) and ov.has_edge(pid, 3)
    deltas = ov.deltas_since(0)
    assert deltas[0].op == "remove_peer" and deltas[0].nodes[0] == 7
    assert [d.version for d in deltas] == sorted(d.version for d in deltas)
    assert [d.version for d in ov.deltas_since(2)] == [
        d.version for d in rov.deltas_since(2)]
    np.testing.assert_array_equal(ov.alive_peers(), rov.alive_peers())
    # the wrapped topology was snapshotted; copy=False adopts it
    assert len(ov.top.neighbors) == 41
    assert Overlay(ov.top, copy=False).top is ov.top


def test_overlay_rejects_invalid_mutations():
    rov, ov = _pair(ref_ba(20, m=2, seed=0))
    if not ov.has_edge(0, 19):
        _both(rov, ov, lambda o: o.add_edge(0, 19))
    absent = next(v for v in range(1, 20) if not ov.has_edge(0, v))
    for op, match in ((lambda o: o.add_edge(3, 3), "self-loop"),
                      (lambda o: o.add_edge(0, 19), "already exists"),
                      (lambda o: o.remove_edge(0, absent), "does not exist"),
                      (lambda o: o.add_edge(0, 99), "out of range"),
                      (lambda o: o.add_peer(neighbors=(0,),
                                            coords=(0.1, 0.2)),
                       "no coordinates"),
                      (lambda o: o.remove_peer(2, repair="nope"),
                       "unknown repair")):
        for o in (ov, rov):
            with pytest.raises((ValueError, KeyError), match=match):
                op(o)
    _assert_same_overlay(rov, ov)


def test_add_peer_coords_on_embedded_topology():
    rov, ov = _pair(ref_waxman(30, seed=2))
    pid = _both(rov, ov, lambda o: o.add_peer(neighbors=(0, 1)))
    np.testing.assert_allclose(ov.top.coords[pid],
                               ov.top.coords[[0, 1]].mean(axis=0))
    pid2 = _both(rov, ov, lambda o: o.add_peer(neighbors=(2,),
                                               coords=(0.25, 0.75)))
    np.testing.assert_array_equal(ov.top.coords[pid2], [0.25, 0.75])
    pid3 = _both(rov, ov, lambda o: o.add_peer())      # link-less: center
    np.testing.assert_array_equal(ov.top.coords[pid3], [0.5, 0.5])


# --------------------------------------------------------------------------
# incremental plan sync: edge cases, bit-exact vs rebuild and reference
# --------------------------------------------------------------------------

def test_sync_noop_and_version_tracking():
    rov, ov = _pair(ref_ba(60, m=2, seed=3))
    plan = NetworkPlan(ov)
    assert plan.overlay is ov and plan.sync() is False
    ov.add_edge(0, 50) if not ov.has_edge(0, 50) else ov.remove_edge(0, 50)
    assert plan.sync() is True and plan.version == ov.version
    assert plan.sync() is False
    # a plan of a frozen topology adopts an overlay of that topology
    frozen = NetworkPlan(ov.top)
    assert frozen.overlay is None and frozen.sync() is False
    assert frozen.sync(ov) is True and frozen.overlay is ov
    with pytest.raises(ValueError, match="different Topology"):
        frozen.sync(Overlay(ov.top))


def test_sync_cut_vertex_removal_splits_origin_component():
    # two BA blobs bridged through one cut vertex
    a, b = ref_ba(30, m=2, seed=4), ref_ba(30, m=2, seed=5)
    nb = [x.copy() for x in a.neighbors]
    nb += [(x + 30).astype(np.int32) for x in b.neighbors]
    ref_top = RefTopology(n=60, neighbors=[np.sort(x) for x in nb],
                          kind="ba")
    rov, ov, ref_eng, eng = _engines(ref_top)
    _both(rov, ov, lambda o: (o.add_edge(0, 29), o.add_edge(29, 30)))
    spec = QuerySpec(origins=(0, 45))
    _same_bits(eng.run(spec, "fd-st1+2"),
               ref_eng.run(_ref_spec(spec), "fd-st1+2"), "warm")
    _both(rov, ov, lambda o: o.remove_peer(29))        # the cut vertex
    _, _, reached = bfs_tree(ov.top, 0, ov.n)
    assert not reached[45]                              # component split
    _assert_plans_agree(eng, ref_eng, (0, 45))


def test_sync_removing_the_origin_itself():
    rov, ov, ref_eng, eng = _engines(ref_ba(50, m=2, seed=6))
    eng.run(QuerySpec(origins=(13,)), "fd-dynamic")     # cache origin 13
    ref_eng.run(ref_engine.QuerySpec(origins=(13,)), "fd-dynamic")
    _both(rov, ov, lambda o: o.remove_peer(13))
    res = eng.run(QuerySpec(origins=(13,)), "fd-st1+2")
    assert res.metrics.n_reached[0, 0] == 1             # only itself
    _assert_plans_agree(eng, ref_eng, (13, 0))


def test_sync_join_shortens_eccentricity_auto_ttl_shrinks():
    rov, ov, ref_eng, eng = _engines(_path(10))
    assert eng.plan.auto_ttl(0) == 9
    pid = _both(rov, ov, lambda o: o.add_peer(neighbors=(0, 9)))
    eng.plan.sync()
    assert eng.plan.auto_ttl(0) == eccentricity_ttl(ov.top, 0) < 9
    assert eng.plan.auto_ttl(pid) == eccentricity_ttl(ov.top, pid)
    _assert_plans_agree(eng, ref_eng, (0, 5), lifetime=float("inf"))


@pytest.mark.parametrize("round_", range(4))
def test_sync_interleaved_fuzz_bit_exact_vs_rebuild(round_):
    """Rounds of random sessions (joins and reconnecting leaves) between
    queries on a Waxman overlay, iid and per-edge latencies; each case
    replays the rounds before it."""
    rov, ov, ref_eng, eng = _engines(ref_waxman(80, seed=7))
    rng = np.random.default_rng(0)
    for r in range(round_ + 1):
        eng.run(QuerySpec(origins=(0, 33, 70), n_trials=2), "fd-dynamic")
        ref_eng.run(ref_engine.QuerySpec(origins=(0, 33, 70), n_trials=2),
                    "fd-dynamic")
        n_ev = int(rng.integers(3, 9))
        events = random_session(ov, n_ev, seed=100 + r, join_prob=0.5)
        assert events == [SessionEvent(*dataclasses.astuple(e)) for e in
                          ref_overlay.random_session(rov, n_ev,
                                                     seed=100 + r,
                                                     join_prob=0.5)]
        apply_events(ov, events, repair="reconnect")
        ref_overlay.apply_events(
            rov, [ref_overlay.SessionEvent(*dataclasses.astuple(e))
                  for e in events], repair="reconnect")
        _assert_same_overlay(rov, ov)
    assert eng.plan.sync() is True
    _assert_plans_agree(eng, ref_eng, (0, 33, 70),
                        latency_models=("iid", "edge"))


def _equal_depth_non_edge(ov, origin):
    _, depth, _ = bfs_tree(ov.top, origin, ov.n)
    return [(u, v) for u in range(ov.n) for v in range(u + 1, ov.n)
            if depth[u] == depth[v] and depth[u] >= 1
            and not ov.has_edge(u, v)]


def test_sync_refreshes_edge_latency_tier():
    # an edge delta that moves no cached BFS tree must still refresh the
    # forward masks and the edge latencies (the refresh_edges tier)
    rov, ov, ref_eng, eng = _engines(ref_waxman(60, seed=8))
    spec = QuerySpec(origins=(0,), latency_model="edge")
    _same_bits(eng.run(spec, "fd-st1+2"),
               ref_eng.run(_ref_spec(spec), "fd-st1+2"), "warm")
    u, v = _equal_depth_non_edge(ov, 0)[0]
    _both(rov, ov, lambda o: o.add_edge(u, v))
    _assert_plans_agree(eng, ref_eng, (0,), lifetime=float("inf"),
                        latency_models=("iid", "edge"))


def test_patch_tree_skips_bfs_and_matches_fresh_flood(monkeypatch):
    # a leaf leave + a join are rank-certified: sync must not re-flood
    # any cached tree, yet land bit-identical to a fresh plan's BFS
    rov, ov, ref_eng, eng = _engines(_path(30))
    eng.plan.origin_statics(np.asarray([3]), 0, "st1+2")
    ref_eng.plan.origin_statics(np.asarray([3]), 0, "st1+2")

    def boom(*a, **k):
        raise AssertionError("sync re-flooded a rank-certified delta")

    monkeypatch.setattr(planmod, "bfs_tree_csr_multi", boom)
    _both(rov, ov, lambda o: o.remove_peer(29))         # childless leaf
    eng.plan.sync()
    pid = _both(rov, ov, lambda o: o.add_peer(neighbors=(0,)))
    eng.plan.sync()
    monkeypatch.undo()
    (a,), _ = eng.plan.origin_statics(np.asarray([3]), 0, "st1+2")
    (b,), _ = NetworkPlan(ov.top).origin_statics(np.asarray([3]), 0,
                                                 "st1+2")
    for f in ("parent", "depth", "rank", "idx", "ttl_rem", "kid_sorted",
              "kid_ptr", "ttl"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.depth[pid] == 4 and a.depth[29] == -1
    _assert_plans_agree(eng, ref_eng, (3, pid), lifetime=float("inf"))


def test_patch_tree_bails_to_bfs_on_structural_shortcut(monkeypatch):
    # a long-range shortcut re-parents a node WITH tree children: the
    # certificate cannot cover the cascade, so sync re-floods (and the
    # re-flood is still bit-exact vs a rebuild)
    rov, ov, ref_eng, eng = _engines(_path(30))
    eng.plan.origin_statics(np.asarray([3]), 0, "st1+2")
    calls = []
    real = planmod.bfs_tree_csr_multi

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(planmod, "bfs_tree_csr_multi", spy)
    _both(rov, ov, lambda o: o.add_edge(4, 20))         # 20 keeps child 21
    eng.plan.sync()
    monkeypatch.undo()
    assert calls, "structural delta must fall back to the BFS sweep"
    _assert_plans_agree(eng, ref_eng, (3,), lifetime=float("inf"))


# --------------------------------------------------------------------------
# session dynamics, repair policies, the registry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,join_prob", [(3, 0.5), (4, 0.2), (5, 0.9)])
def test_random_session_matches_reference(seed, join_prob):
    rov, ov = _pair(ref_ba(40, m=2, seed=9))
    ev = random_session(ov, 20, seed=seed, join_prob=join_prob)
    ref_ev = ref_overlay.random_session(rov, 20, seed=seed,
                                        join_prob=join_prob)
    assert ([dataclasses.astuple(e) for e in ev]
            == [dataclasses.astuple(e) for e in ref_ev])
    assert ev == random_session(ov, 20, seed=seed, join_prob=join_prob)
    joined = apply_events(ov, ev)
    assert joined == ref_overlay.apply_events(rov, ref_ev)
    assert len(joined) == sum(1 for e in ev if e.kind == "join")
    _assert_same_overlay(rov, ov)
    with pytest.raises(ValueError, match="unknown session event"):
        apply_events(ov, [SessionEvent("flap")])


def test_repair_reconnect_preserves_connectivity():
    rov, ov = _pair(_path(12))
    _both(rov, ov, lambda o: o.remove_peer(6, repair="reconnect"))
    _, _, reached = bfs_tree(ov.top, 0, ov.n)
    assert reached.sum() == 11              # everyone but the tombstone
    rov2, ov2 = _pair(_path(12))
    _both(rov2, ov2, lambda o: o.remove_peer(6, repair="none"))
    _, _, reached2 = bfs_tree(ov2.top, 0, ov2.n)
    assert reached2.sum() == 6              # split: only the left half


def test_registry_surface_uniform():
    from repro.engine import registry as ref_registry
    for kind in ("repairs", "placements", "policies", "topologies"):
        assert (getattr(registry, f"available_{kind}")()
                == getattr(ref_registry, f"available_{kind}")()), kind
    assert {"none", "reconnect"} <= set(registry.available_repairs())
    assert registry.get_repair("reconnect") is not None
    with pytest.raises(KeyError, match="registered"):
        registry.get_repair("nope")
    with pytest.raises(KeyError, match="registered"):
        registry.get_placement("nope")
    assert "fd-dynamic" in registry.available_policies()
    assert "waxman" in registry.available_topologies()
    assert sorted(registry.__all__) == sorted(ref_registry.__all__)


# --------------------------------------------------------------------------
# the engine re-syncing between queries; replication after a mutation
# --------------------------------------------------------------------------

def test_engine_syncs_live_overlay_between_queries():
    rov, ov, ref_eng, eng = _engines(ref_ba(70, m=2, seed=15))
    r1 = eng.run(QuerySpec(origins=(0,)), "fd-st1+2")
    ref_eng.run(ref_engine.QuerySpec(origins=(0,)), "fd-st1+2")
    nb = int(ov.top.neighbors[0][0])
    _both(rov, ov, lambda o: o.remove_peer(nb))
    r2 = eng.run(QuerySpec(origins=(0,)), "fd-st1+2")   # auto re-synced
    assert eng.plan.version == ov.version
    fresh = SimEngine(NetworkPlan(ov.top), PA, device="cpu").run(
        QuerySpec(origins=(0,)), "fd-st1+2")
    assert r2.query_metrics(0, 0) == fresh.query_metrics(0, 0)
    _same_bits(r2, ref_eng.run(ref_engine.QuerySpec(origins=(0,)),
                               "fd-st1+2"), "after the leave")
    assert r1.metrics.n_reached[0, 0] >= r2.metrics.n_reached[0, 0]


@pytest.mark.parametrize("placement", ["random", "neighbor"])
def test_replication_after_a_mutation(placement):
    params = dataclasses.replace(PA, replication_factor=2,
                                 replication_placement=placement)
    rov, ov, ref_eng, eng = _engines(ref_ba(80, m=2, seed=10), params)
    eng.run(QuerySpec(origins=(0, 11)), "fd-dynamic")
    ref_eng.run(ref_engine.QuerySpec(origins=(0, 11)), "fd-dynamic")
    before = eng.plan.replica_table(params)
    assert before.shape == (80, 2)
    _both(rov, ov, lambda o: o.add_peer(neighbors=(0, 11)))
    _both(rov, ov, lambda o: o.remove_peer(5, repair="reconnect"))
    eng.plan.sync()
    after = eng.plan.replica_table(params)
    assert after is not before and after.shape == (81, 2)
    np.testing.assert_array_equal(after,
                                  NetworkPlan(ov.top).replica_table(params))
    _assert_plans_agree(eng, ref_eng, (0, 11), lifetime=15.0)


# --------------------------------------------------------------------------
# the port's own pieces against the reference's
# --------------------------------------------------------------------------

def _scenario(name, o):
    """One op stream on a warmed overlay ``o`` (port's or reference's)."""
    if name == "leaf-leave":
        o.remove_peer(29)
    elif name == "join":
        o.add_peer(neighbors=(0,))
    elif name == "rewire":                  # tree edge out, new parent in
        o.remove_edge(28, 29)
        o.add_edge(27, 29)
    elif name == "shortcut":                # bails: 20 has tree children
        o.add_edge(4, 20)
    elif name == "origin-leave":
        o.remove_peer(3, repair="reconnect")
    elif name == "chord":                   # non-tree edge, tree intact
        o.add_edge(10, 12)
    elif name == "many":                    # past _PATCH_MAX_OPS
        for v in range(14, 27):
            o.add_peer(neighbors=(v,))
    else:
        raise ValueError(name)


SCENARIOS = ("leaf-leave", "join", "rewire", "shortcut", "origin-leave",
             "chord", "many")


def _assert_same_static(a, b, ctx):
    for f in STATIC_FIELDS:
        x, y = getattr(a, f, None), getattr(b, f, None)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f"{ctx}: {f} dtype"
            np.testing.assert_array_equal(x, y, err_msg=f"{ctx}: {f}")
        else:
            assert x == y, f"{ctx}: {f}"
    assert len(a.levels) == len(b.levels), ctx
    for x, y in zip(a.levels, b.levels):
        np.testing.assert_array_equal(x, y, err_msg=f"{ctx}: levels")


@pytest.mark.parametrize("strategy", ["st1+2", "basic"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_patch_tree_and_patched_static_match_reference(name, strategy):
    """On the same inputs, the port's ``_patch_tree`` returns the
    reference's (parent, depth, reached, rank) or None where it does, and
    ``_OriginStatic.patched`` the reference's static or None where it
    does; either static equals one built from scratch."""
    ref_top = _path(30)
    rov, ov = _pair(ref_top)
    plan, ref_plan = NetworkPlan(ov), RefPlan(rov)
    origins = np.asarray([3, 17])
    sts, _ = plan.origin_statics(origins, 0, strategy)
    ref_sts, _ = ref_plan.origin_statics(origins, 0, strategy)
    old_csr = (ov.n, plan.indptr, plan.indices, plan.e_src, plan.e_dst,
               plan.edge_keys)
    ref_old = (rov.n, ref_plan.indptr, ref_plan.indices, ref_plan.e_src,
               ref_plan.e_dst, ref_plan.edge_keys)
    _scenario(name, ov)
    _scenario(name, rov)
    _assert_same_overlay(rov, ov)
    deltas, ref_deltas = ov.deltas_since(0), rov.deltas_since(0)
    removed, added = planmod._edge_delta(deltas)
    assert (removed, added) == ref_planmod._edge_delta(ref_deltas)
    new, ref_new = NetworkPlan(ov.top), RefPlan(rov.top)
    n = ov.n
    for st, ref_st in zip(sts, ref_sts):
        ctx = f"{name} origin {st.origin}"
        got = planmod._patch_tree(st, deltas, n, n, new.indptr,
                                  new.indices)
        want = ref_planmod._patch_tree(ref_st, ref_deltas, n, n,
                                       ref_new.indptr, ref_new.indices)
        assert (got is None) == (want is None), ctx
        if want is not None:
            for x, y in zip(got, want):
                assert x.dtype == y.dtype, ctx
                np.testing.assert_array_equal(x, y, err_msg=ctx)
        bfs = got
        if bfs is None:
            bfs = tuple(a[0] for a in planmod.bfs_tree_csr_multi(
                new.indptr, new.indices, np.asarray([st.origin]), n,
                return_rank=True))
        args = (new.indptr, new.indices, new.e_src, new.e_dst,
                new.edge_keys, new.degrees, 0, bfs, new.edge_lat, old_csr,
                removed, added)
        ref_args = (ref_new.indptr, ref_new.indices, ref_new.e_src,
                    ref_new.e_dst, ref_new.edge_keys, ref_new.degrees, 0,
                    bfs, ref_new.edge_lat, ref_old, removed, added)
        p_st = _OriginStatic.patched(st, ov.top, *args)
        r_st = RefStatic.patched(ref_st, rov.top, *ref_args)
        assert (p_st is None) == (r_st is None), ctx
        fresh = _OriginStatic(ov.top, new.indptr, new.indices, new.e_src,
                              new.e_dst, new.edge_keys, new.degrees,
                              st.origin, 0, strategy, bfs=bfs,
                              edge_lat=new.edge_lat)
        if r_st is not None:
            _assert_same_static(p_st, r_st, ctx + " vs reference")
            _assert_same_static(p_st, fresh, ctx + " vs rebuild")


def _assert_same_nested(a, b, ctx):
    """Equal arrays (values and dtype), Nones and tuples of them."""
    if isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b), ctx
        for x, y in zip(a, b):
            _assert_same_nested(x, y, ctx)
    elif b is None:
        assert a is None, ctx
    else:
        assert a.dtype == b.dtype, ctx
        np.testing.assert_array_equal(a, b, err_msg=ctx)


def _assert_same_levels(got, want, ctx):
    assert len(got) == len(want), ctx
    for d, (x, y) in enumerate(zip(got, want)):
        assert sorted(x) == sorted(y), f"{ctx}: level {d} keys"
        for f in y:
            _assert_same_nested(x[f], y[f], f"{ctx}: {d}.{f}")


@pytest.mark.parametrize("ttl", [0, 30])
@pytest.mark.parametrize("reroute", [False, True])
@pytest.mark.parametrize("name", SCENARIOS)
def test_depth_slices_reuse_matches_reference(name, reroute, ttl):
    """After a sync, each cached ``DepthSlices`` is kept, rebuilt over the
    old levels or dropped as the reference's is, adopts the same levels
    (by identity with the old ones), and its level dicts equal the
    reference's and a from-scratch compile's.

    The slices are cached under the static's resolved TTL and the statics
    under the requested one, so with an auto-TTL (``ttl=0``) sync drops
    every cached ``DepthSlices`` and the next query compiles it anew, in
    both packages; an explicit TTL runs the reuse path."""
    rov, ov = _pair(_path(30))
    plan, ref_plan = NetworkPlan(ov), RefPlan(rov)
    origins = np.asarray([3, 17])
    old, ref_old = {}, {}
    for p_, store in ((plan, old), (ref_plan, ref_old)):
        sts, _ = p_.origin_statics(origins, ttl, "st1+2")
        for st in sts:
            store[st.origin] = p_.depth_slices(st, reroute=reroute)
    _scenario(name, ov)
    _scenario(name, rov)
    assert plan.sync() and ref_plan.sync()
    for o in origins.tolist():
        st = plan._statics[(o, ttl, "st1+2")]
        ref_st = ref_plan._statics[(o, ttl, "st1+2")]
        key = (o, st.ttl, "st1+2")
        kept, ref_kept = plan._slices.get(key), ref_plan._slices.get(key)
        assert (kept is None) == (ref_kept is None) == (ttl == 0), name
        sl = plan.depth_slices(st, reroute=reroute)
        ref_sl = ref_plan.depth_slices(ref_st, reroute=reroute)
        assert (sl is old[o]) == (ref_sl is ref_old[o]), name
        assert sl.reroute == ref_sl.reroute == reroute
        adopted = [any(lv is x for x in old[o].levels) for lv in sl.levels]
        ref_adopted = [any(lv is x for x in ref_old[o].levels)
                       for lv in ref_sl.levels]
        assert adopted == ref_adopted, f"{name} origin {o}"
        _assert_same_levels(sl.levels, ref_sl.levels, f"{name} {o}")
        fresh = DepthSlices(st, ov.n, reroute=reroute,
                            index_dtype=plan.index_dtype)
        _assert_same_levels(sl.levels, fresh.levels, f"{name} {o} rebuild")
        for f in ("els_src", "els_dst", "cond"):
            np.testing.assert_array_equal(getattr(sl, f),
                                          getattr(ref_sl, f))


def test_device_slices_follow_a_tree_intact_rewire():
    """A chord between two peers of one level leaves origin 0's tree and
    its ``DepthSlices`` instance intact (an explicit TTL keeps the slices
    across a sync) but changes its Strategy-1 edge arrays: the device
    copies must be the new ones, not a stale cache."""
    params = dataclasses.replace(PA, ttl=6)
    rov, ov, ref_eng, eng = _engines(ref_waxman(60, seed=8), params)
    spec = QuerySpec(origins=(0,), n_trials=2, rng="independent")
    eng.run(spec, "fd-st1+2")
    ref_eng.run(_ref_spec(spec), "fd-st1+2")
    key = (0, params.ttl, "st1+2")
    sl = eng.plan._slices[key]
    old_els = (sl.els_src, sl.els_dst, sl.cond)
    stale = _device_slices(sl, CPU)[1]
    u, v = _equal_depth_non_edge(ov, 0)[0]
    _both(rov, ov, lambda o: o.add_edge(u, v))
    assert eng.plan.sync() is True
    assert eng.plan._slices[key] is sl            # the tree was intact
    assert not all(np.array_equal(a, b) for a, b in
                   zip(old_els, (sl.els_src, sl.els_dst, sl.cond)))
    src, dst, cond = _device_slices(sl, CPU)[1]
    assert src is not stale[0]
    np.testing.assert_array_equal(src.numpy(), sl.els_src)
    np.testing.assert_array_equal(dst.numpy(), sl.els_dst)
    np.testing.assert_array_equal(cond.numpy(), sl.cond)
    _same_bits(eng.run(spec, "fd-st1+2"),
               ref_eng.run(_ref_spec(spec), "fd-st1+2"), "after the chord")


@pytest.mark.parametrize("lifetime", [float("inf"), LIFETIME])
def test_request_from_a_tombstoned_origin(lifetime):
    """A session removes a cached origin; a later request from it reaches
    only itself and still gives the reference's bits, as does a request
    from a peer that joined."""
    rov, ov, ref_eng, eng = _engines(ref_ba(90, m=2, seed=21))
    spec = QuerySpec(origins=(4, 8), n_trials=2, rng="independent")
    pol = get_policy("fd-dynamic").variant(lifetime_mean_s=lifetime)
    ref_pol = ref_engine.get_policy("fd-dynamic").variant(
        lifetime_mean_s=lifetime)
    eng.run(spec, pol)
    ref_eng.run(_ref_spec(spec), ref_pol)
    _both(rov, ov, lambda o: o.remove_peer(4, repair="reconnect"))
    joined = _both(rov, ov, lambda o: o.add_peer(neighbors=(8,)))
    spec = QuerySpec(origins=(4, joined, 8), n_trials=2, rng="independent")
    got = eng.run(spec, pol)
    assert (got.metrics.n_reached[0] == 1).all()
    assert got.values.shape == (3, 2, PA.k)
    _same_bits(got, ref_eng.run(_ref_spec(spec), ref_pol), "tombstone")
    _assert_plans_agree(eng, ref_eng, (4, joined), lifetime=lifetime)


def test_query_server_over_a_live_overlay():
    """A ``QueryServer`` over an overlay-bound CPU engine, the overlay
    mutated only between drained batches: every served answer equals a
    from-scratch plan's and the reference's."""
    rov, ov, ref_eng, eng = _engines(ref_ba(120, m=2, seed=23))
    churn = get_policy("fd-dynamic").variant(lifetime_mean_s=LIFETIME)
    ref_churn = ref_engine.get_policy("fd-dynamic").variant(
        lifetime_mean_s=LIFETIME)
    with QueryServer(eng) as server:
        for batch in range(3):
            reqs = [(QuerySpec(origins=(o,), seed=50 + 7 * batch + o,
                               rng="independent"), pol, ref_pol)
                    for o in (0, 9, 31)
                    for pol, ref_pol in (("fd-dynamic", "fd-dynamic"),
                                         (churn, ref_churn))]
            handles = [server.submit(spec, pol) for spec, pol, _ in reqs]
            served = [h.result(timeout=120) for h in handles]
            fresh = SimEngine(NetworkPlan(ov.top), PA, device="cpu")
            for (spec, pol, ref_pol), res in zip(reqs, served):
                ctx = f"batch {batch} {spec.origins}"
                _same_bits(res, fresh.run(spec, pol), ctx + " vs rebuild")
                _same_bits(res, ref_eng.run(_ref_spec(spec), ref_pol),
                           ctx + " vs reference")
            assert eng.plan.version == ov.version
            # drained: mutate between batches only
            events = random_session(ov, 4, seed=300 + batch)
            apply_events(ov, events, repair="reconnect")
            ref_overlay.apply_events(
                rov, [ref_overlay.SessionEvent(*dataclasses.astuple(e))
                      for e in events], repair="reconnect")
    m = server.metrics()
    assert m.served == m.submitted == 18 and m.failed == 0
