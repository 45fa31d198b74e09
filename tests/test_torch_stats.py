"""The port's scalar reference run and the two-round ``fd-stats``
heuristic on the CPU against the reference package, exactly.

Mirrors tests/test_engine.py (``fd-stats`` against the legacy heuristic),
tests/test_topologies.py (``fd-stats`` under per-edge latencies),
tests/test_serving.py (``fd-stats`` never coalesces) and
tests/test_properties.py (``fd-stats`` reports its host path and refuses
reduced precision).  ``run_query_reference`` draws from one generator in
a fixed order, so the port's copy must give the reference's
``QueryMetrics`` and per-peer state exactly, for every algorithm and
strategy, with and without churn and pruning.
"""
import dataclasses
import warnings

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.engine as ref_engine
from repro.p2psim import SimParams as RefParams
from repro.p2psim import barabasi_albert as ref_ba
from repro.p2psim import run_query_reference as ref_run_query
from repro.p2psim.graph import bfs_tree as ref_bfs_tree
from repro.p2psim.graph import eccentricity_ttl as ref_ecc
from repro.p2psim.topologies import hierarchical as ref_hierarchical
from repro_torch.engine import QuerySpec, SimEngine, get_policy
from repro_torch.p2psim import (SimParams, bfs_tree, eccentricity_ttl,
                                run_query_reference, topology_from_arrays)

FIELDS = ("n_reached", "n_edges_pq", "avg_degree", "m_fw", "b_fw", "m_bw",
          "m_rt", "b_bw", "b_rt", "response_time_s", "accuracy")
# (algorithm, strategy, dynamic) of every policy's scalar run
RUNS = (("fd", "basic", False), ("fd", "st1", False),
        ("fd", "st1+2", False), ("fd", "st1+2", True),
        ("cn", "st1+2", True), ("cn_star", "st1+2", True))
REF_TOP = ref_ba(220, m=2, seed=7)
TOP = topology_from_arrays(REF_TOP.n, REF_TOP.neighbors, REF_TOP.kind)
REF_PA = RefParams(seed=11)
PA = SimParams(**dataclasses.asdict(REF_PA))
REF_HTOP = ref_hierarchical(300, seed=3)
HTOP = topology_from_arrays(REF_HTOP.n, REF_HTOP.neighbors, REF_HTOP.kind,
                            REF_HTOP.coords)
REF_EDGE = RefParams(seed=11, latency_model="edge")
PA_EDGE = SimParams(**dataclasses.asdict(REF_EDGE))


def _carry(ref_top):
    return topology_from_arrays(ref_top.n, ref_top.neighbors, ref_top.kind,
                                ref_top.coords)


def _assert_state_equal(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, list):
            assert len(g) == len(w), key
            for a, b in zip(g, w):
                assert (a is None and b is None) or (
                    np.array_equal(a, b) and np.asarray(a).dtype
                    == np.asarray(b).dtype), key
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), key


def _stats(engine, spec, policy="fd-stats"):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return engine.run(spec, policy)


def _assert_stats_equal(got, want):
    assert got.backend_used == want.backend_used == "sim"
    assert (got.topology, got.latency_model) == (want.topology,
                                                 want.latency_model)
    for key in ("metrics_full", "metrics_pruned"):
        assert (dataclasses.asdict(got.extras[key])
                == dataclasses.asdict(want.extras[key])), key
    for key in ("comm_reduction", "accuracy", "z"):
        assert got.extras[key] == want.extras[key], key
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got.metrics, f),
                                      getattr(want.metrics, f), err_msg=f)
    assert got.values is None and got.indices is None


@settings(max_examples=8, deadline=None)
@given(n=st.integers(12, 40), m=st.integers(1, 3),
       seed=st.integers(0, 10_000), run=st.integers(0, len(RUNS) - 1),
       churn=st.integers(0, 1), prune=st.integers(0, 1))
def test_run_query_reference_matches_reference(n, m, seed, run, churn,
                                               prune):
    algorithm, strategy, dynamic = RUNS[run]
    ref_top = ref_ba(n, max(1, min(m, n - 1)), seed=seed)
    ref_p = RefParams(k=4, seed=seed + 1)
    kw = {"algorithm": algorithm, "strategy": strategy, "dynamic": dynamic,
          "lifetime_mean_s": 3.0 if churn else float("inf"),
          "return_state": True}
    if prune and algorithm == "fd":
        kw["child_mask"] = np.random.default_rng(seed).random(n) < 0.8
    got, got_st = run_query_reference(
        _carry(ref_top), n // 3, SimParams(**dataclasses.asdict(ref_p)),
        **kw)
    want, want_st = ref_run_query(ref_top, n // 3, ref_p, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    _assert_state_equal(got_st, want_st)


def test_scalar_flood_matches_reference():
    for ref_top in (REF_TOP, REF_HTOP):
        top = _carry(ref_top)
        for origin, ttl in ((0, 3), (7, 100)):
            for a, b in zip(bfs_tree(top, origin, ttl),
                            ref_bfs_tree(ref_top, origin, ttl)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        assert eccentricity_ttl(top, 5) == ref_ecc(ref_top, 5)


@pytest.mark.parametrize("z", [0.8, 1.0])
def test_fd_stats_matches_reference(z):
    """Both rounds' metrics, the traffic cut and the accuracy equal the
    reference's; the rounds ran at the plan's auto-TTL; an explicit
    (1, 1) seeds grid selects the stream."""
    port = SimEngine(TOP, PA, device="cpu")
    ref = ref_engine.SimEngine(REF_TOP, REF_PA)
    pol = get_policy("fd-stats").variant(z=z)
    ref_pol = ref_engine.get_policy("fd-stats").variant(z=z)
    got = _stats(port, QuerySpec(origins=(0,)), pol)
    _assert_stats_equal(got, ref.run(ref_engine.QuerySpec(origins=(0,)),
                                     ref_pol))
    assert got.extras["comm_reduction"] > 0.0
    assert got.extras["accuracy"] > 0.5
    assert got.query_metrics(0, 0) == got.extras["metrics_pruned"]
    assert port.plan.cache_info()["auto_ttls"] == 1
    seeded = _stats(port, QuerySpec(origins=(3,), seeds=[[42]]), pol)
    _assert_stats_equal(seeded, ref.run(
        ref_engine.QuerySpec(origins=(3,), seeds=[[42]]), ref_pol))
    for bad in (QuerySpec(origins=(0, 1)), QuerySpec(origins=(0,),
                                                     seeds=[[1, 2]])):
        with pytest.raises(ValueError):
            _stats(port, bad, pol)


def test_fd_stats_edge_latency_matches_reference():
    """The two rounds thread the per-edge latency model through."""
    got = _stats(SimEngine(HTOP, PA_EDGE, device="cpu"),
                 QuerySpec(origins=(0,)))
    want = ref_engine.SimEngine(REF_HTOP, REF_EDGE).run(
        ref_engine.QuerySpec(origins=(0,)), "fd-stats")
    _assert_stats_equal(got, want)
    assert got.latency_model == "edge" and got.topology == "hierarchical"
    assert got.extras["comm_reduction"] > 0.0


def test_fd_stats_churn_variant_matches_reference():
    """A finite lifetime does not reach the two rounds, in the reference
    or the port: the churn variant answers as the static policy."""
    pol = get_policy("fd-stats").variant(lifetime_mean_s=20.0)
    port = SimEngine(TOP, PA, device="cpu")
    got = _stats(port, QuerySpec(origins=(4,)), pol)
    want = ref_engine.SimEngine(REF_TOP, REF_PA).run(
        ref_engine.QuerySpec(origins=(4,)),
        ref_engine.get_policy("fd-stats").variant(lifetime_mean_s=20.0))
    _assert_stats_equal(got, want)
    static = _stats(port, QuerySpec(origins=(4,)))
    assert got.extras["metrics_full"] == static.extras["metrics_full"]


def test_fd_stats_never_coalesces():
    """run_many runs each fd-stats request alone, beside a fused group of
    fd-dynamic requests, each equal to a sequential run."""
    port = SimEngine(TOP, PA, device="cpu")
    specs = [QuerySpec(origins=(0,), seed=3), QuerySpec(origins=(5,), seed=4),
             QuerySpec(origins=(0,), seed=3, rng="independent"),
             QuerySpec(origins=(9,), seed=8, rng="independent")]
    pols = ["fd-stats", "fd-stats", "fd-dynamic", "fd-dynamic"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = port.run_many(specs, pols)
    assert [r.batch_size for r in out] == [1, 1, 2, 2]
    for spec, pol, r in zip(specs[:2], pols[:2], out[:2]):
        _assert_stats_equal(r, _stats(port, spec, pol))
    assert not SimEngine._coalescable(QuerySpec(rng="independent"),
                                      get_policy("fd-stats"))


def test_fd_stats_reports_host_path_and_warns_once():
    port = SimEngine(TOP, PA, device="cpu")
    with pytest.warns(RuntimeWarning, match="host reference path"):
        res = port.run(QuerySpec(origins=(0,)), "fd-stats")
    assert res.backend == "sim-torch" and res.backend_used == "sim"
    assert res.precision == "f64"
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        port.run(QuerySpec(origins=(2,)), "fd-stats")    # no second warning


def test_fd_stats_rejects_reduced_precision():
    """The scalar reference path is f64 only, as in the reference."""
    with pytest.raises(ValueError, match="fd-stats"):
        SimEngine(TOP, PA, device="cpu", precision="f32").run(
            QuerySpec(origins=(0,)), "fd-stats")
    with pytest.raises(ValueError, match="fd-stats"):
        SimEngine(TOP, PA, device="cpu").run(
            QuerySpec(origins=(0,), precision="bf16"), "fd-stats")
    ref = ref_engine.SimEngine(REF_TOP, REF_PA, backend="jax",
                               precision="f32")
    with pytest.raises(ValueError, match="fd-stats"):
        ref.run(ref_engine.QuerySpec(origins=(0,)), "fd-stats")
