"""Churn (§4), §4.2 dead-parent rerouting and the CN / CN* baselines in
the port's SimEngine on the CPU, against the reference package, bit for
bit.

Mirrors tests/test_engine.py's churn and baseline tests: every standard
policy at ``lifetime_mean_s=25`` in every RNG mode against the reference
numpy engine and, entry by entry, against ``run_query_reference``; CN /
CN* without churn; one churn + reroute spec against the jitted JAX
sweep; the ``CHURN_TREE`` reroute cascade and the lifetime shorter than
a hop.  Every comparison is exact: ``values``, ``indices`` and every
``BatchMetrics`` field.
"""
import dataclasses
import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.engine as ref_engine
from repro.p2psim import SimParams as RefParams
from repro.p2psim import barabasi_albert as ref_ba
from repro.p2psim import run_query_reference
from repro.p2psim.graph import Topology as RefTopology
from repro_torch.engine import QuerySpec, SimEngine, get_policy
from repro_torch.p2psim import SimParams, topology_from_arrays
from repro_torch.p2psim.simulate import _precompute_draws

STANDARD = ("fd-basic", "fd-st1", "fd-st1+2", "fd-dynamic", "cn",
            "cn-star")
FIELDS = ("n_reached", "n_edges_pq", "avg_degree", "m_fw", "b_fw", "m_bw",
          "m_rt", "b_bw", "b_rt", "response_time_s", "accuracy")
LIFETIME = 25.0
REF_TOP = ref_ba(220, m=2, seed=7)
REF_PA = RefParams(seed=11)


def _carry(ref_top):
    return topology_from_arrays(ref_top.n, ref_top.neighbors, ref_top.kind)


TOP = _carry(REF_TOP)
PA = SimParams(**dataclasses.asdict(REF_PA))

SPECS = {
    "shared-1": QuerySpec(origins=(5,), seed=2),
    "shared-many": QuerySpec(origins=(1, 8), n_trials=3),
    "independent": QuerySpec(origins=(0, 7, 7), n_trials=2,
                             rng="independent"),
    "seeds": QuerySpec(origins=(0, 9), n_trials=2,
                       seeds=np.array([[101, 202], [303, 404]])),
}


def _ref_spec(spec):
    return ref_engine.QuerySpec(**{f.name: getattr(spec, f.name)
                                   for f in dataclasses.fields(spec)})


def _pols(name, lifetime):
    """The port's and the reference's policy ``name`` at ``lifetime``."""
    return (get_policy(name).variant(lifetime_mean_s=lifetime),
            ref_engine.get_policy(name).variant(lifetime_mean_s=lifetime))


def _legacy_kwargs(pol) -> dict:
    kw = dict(algorithm=pol.algorithm, strategy=pol.strategy,
              dynamic=pol.dynamic)
    if not math.isinf(pol.lifetime_mean_s):
        kw["lifetime_mean_s"] = pol.lifetime_mean_s
    return kw


def _assert_same(port, ref, ctx):
    assert port.backend == port.backend_used == "sim-torch", ctx
    assert port.k == ref.k and port.policy == ref.policy, ctx
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port.metrics, f),
                                      getattr(ref.metrics, f),
                                      err_msg=f"{ctx}: {f}")
    np.testing.assert_array_equal(port.values, ref.values,
                                  err_msg=f"{ctx}: values")
    np.testing.assert_array_equal(port.indices, ref.indices,
                                  err_msg=f"{ctx}: indices")


@pytest.mark.parametrize("name", STANDARD)
def test_churn_matches_reference_every_rng_mode(name):
    pol, ref_pol = _pols(name, LIFETIME)
    port = SimEngine(TOP, PA, device="cpu")
    ref = ref_engine.SimEngine(REF_TOP, REF_PA)
    for mode, spec in SPECS.items():
        _assert_same(port.run(spec, pol), ref.run(_ref_spec(spec), ref_pol),
                     f"{name} churn/{mode}")


@pytest.mark.parametrize("name", STANDARD)
def test_churn_independent_streams_entrywise_reference(name):
    """Each independent-stream entry is the scalar reference's query on
    its own seed, churn and reroute included."""
    pol, ref_pol = _pols(name, LIFETIME)
    origins = (0, 9, 41)
    res = SimEngine(TOP, PA, device="cpu").run(
        QuerySpec(origins=origins, n_trials=2, rng="independent"), pol)
    for q, o in enumerate(origins):
        for t in range(2):
            met, _ = run_query_reference(
                REF_TOP, o,
                dataclasses.replace(REF_PA, seed=REF_PA.seed + q * 2 + t),
                **_legacy_kwargs(ref_pol))
            assert res.query_metrics(q, t).as_dict() == met.as_dict(), (
                name, q, t)


@pytest.mark.parametrize("name", ["cn", "cn-star"])
def test_baselines_without_churn_match_reference(name):
    port = SimEngine(TOP, PA, device="cpu")
    ref = ref_engine.SimEngine(REF_TOP, REF_PA)
    for mode, spec in SPECS.items():
        _assert_same(port.run(spec, name), ref.run(_ref_spec(spec), name),
                     f"{name}/{mode}")


def test_churn_reroute_matches_jax_backend():
    """fd-dynamic under churn (§4.2 reroute slots folded) against the
    reference's jitted sweep."""
    ref_top = ref_ba(96, m=2, seed=3)
    pol, ref_pol = _pols("fd-dynamic", 4.0)
    spec = QuerySpec(origins=(0, 3), n_trials=2, rng="independent")
    rj = ref_engine.SimEngine(ref_top, REF_PA, backend="jax").run(
        _ref_spec(spec), ref_pol)
    assert rj.backend_used == "sim-jax"
    rp = SimEngine(_carry(ref_top), PA, device="cpu").run(spec, pol)
    _assert_same(rp, rj, "jax backend, churn + reroute")
    # the lifetime is short enough that lists were rerouted
    rn = SimEngine(_carry(ref_top), PA, device="cpu").run(
        spec, get_policy("fd-st1+2").variant(lifetime_mean_s=4.0))
    assert (rp.metrics.m_bw > rn.metrics.m_bw).any()


# --------------------------------------------------------------------------
# churn edge cases (tests/test_engine.py's CHURN_TREE scenarios)
# --------------------------------------------------------------------------

def _edges_topology(n, edges):
    adj = [set() for _ in range(n)]
    for u, v in edges:
        adj[u].add(v)
        adj[v].add(u)
    return RefTopology(n, [np.array(sorted(a), np.int32) for a in adj],
                       "test")


# a 5-level tree: levels {0} {1,2} {3,4,5} {6,7,8} {9,10} — grandchildren
# exist at three levels, so reroute cascades
REF_CHURN_TREE = _edges_topology(
    11, [(0, 1), (0, 2), (1, 3), (1, 4), (2, 5), (3, 6), (4, 7), (5, 8),
         (6, 9), (7, 10)])
CHURN_TREE = _carry(REF_CHURN_TREE)


def _churn_reference(seed, lifetime):
    met, st_ = run_query_reference(
        REF_CHURN_TREE, 0, RefParams(seed=seed), lifetime_mean_s=lifetime,
        return_state=True)
    dead = {int(v) for v in np.flatnonzero(st_["reached"])
            if st_["merged_scores"][v] is None}
    return met, st_, dead


def test_churn_entire_level_dead_forces_reroute_cascade():
    """A whole depth level dies before sending: every surviving level-2
    list reaches the origin through §4.2 rerouting, bit for bit with
    the scalar reference and the reference engine."""
    found = None
    for seed in range(500):
        met, st_, dead = _churn_reference(seed, 2.5)
        lvl1 = {int(v) for v in np.flatnonzero(st_["depth"] == 1)}
        lvl2 = {int(v) for v in np.flatnonzero(st_["depth"] == 2)}
        if lvl1 and lvl1 <= dead and (lvl2 - dead):
            found = (seed, met, lvl2 - dead)
            break
    assert found is not None, "no full-level-dead seed found in range"
    seed, met, rerouted = found
    pol, ref_pol = _pols("fd-dynamic", 2.5)
    spec = QuerySpec(origins=(0,), seed=seed)
    res = SimEngine(CHURN_TREE, SimParams(), device="cpu").run(spec, pol)
    assert res.query_metrics(0, 0).as_dict() == met.as_dict()
    _assert_same(res, ref_engine.SimEngine(REF_CHURN_TREE).run(
        _ref_spec(spec), ref_pol), "CHURN_TREE cascade")
    assert met.m_bw >= len(rerouted)


def test_churn_lifetime_shorter_than_one_hop():
    """Every non-origin peer dies before its send time; the origin is
    immortal in the shared draws and answers from its own list."""
    pa = SimParams(seed=3)
    lifetime = 0.01                     # hop latency alone is ~0.2 s
    draws = _precompute_draws(np.array([0]), [pa.seed], CHURN_TREE.n, pa,
                              "fd", "st1+2", lifetime, True)
    assert np.isinf(draws.death[0, 0])
    assert np.isfinite(draws.death[0, 1:]).all()
    met, st_, dead = _churn_reference(pa.seed, lifetime)
    reached = {int(v) for v in np.flatnonzero(st_["reached"])}
    assert 0 not in dead and reached - {0} <= dead
    spec = QuerySpec(origins=(0,), seed=pa.seed)
    for name in ("fd-dynamic", "fd-basic", "cn", "cn-star"):
        pol, ref_pol = _pols(name, lifetime)
        res = SimEngine(CHURN_TREE, pa, device="cpu").run(spec, pol)
        _assert_same(res, ref_engine.SimEngine(
            REF_CHURN_TREE, RefParams(seed=3)).run(_ref_spec(spec),
                                                   ref_pol), name)
        assert int(res.metrics.m_bw[0, 0]) == 0, name   # nobody sent
        if name == "fd-dynamic":
            assert res.query_metrics(0, 0).as_dict() == met.as_dict()
            assert set(res.indices[0, 0].tolist()) == {0}


@settings(max_examples=6, deadline=None)
@given(n=st.integers(12, 40), m=st.integers(1, 3),
       seed=st.integers(0, 10_000), pol=st.integers(0, len(STANDARD) - 1),
       lifetime=st.sampled_from([0.5, 2.0, 8.0, 40.0]),
       rng=st.integers(0, 1))
def test_random_overlays_under_churn_match_reference(n, m, seed, pol,
                                                     lifetime, rng):
    ref_top = ref_ba(n, max(1, min(m, n - 1)), seed=seed)
    ref_p = RefParams(k=4, seed=seed + 1)
    spec = QuerySpec(origins=(0, n // 2), n_trials=2,
                     rng=("shared", "independent")[rng])
    port_pol, ref_pol = _pols(STANDARD[pol], lifetime)
    port = SimEngine(_carry(ref_top), SimParams(**dataclasses.asdict(ref_p)),
                     device="cpu")
    _assert_same(port.run(spec, port_pol),
                 ref_engine.SimEngine(ref_top, ref_p).run(_ref_spec(spec),
                                                          ref_pol),
                 f"n={n} m={m} seed={seed} {STANDARD[pol]} L={lifetime}")


def test_churn_extends_a_warm_plan_without_rebuilding_it():
    """A plan warm on the static path extends its slices with the reroute
    tables at the first churn request (booked in ``compile_s``), keeps
    its static device tensors, and reports no compile after that."""
    from repro_torch.engine.sim_torch import _device_slices
    engine = SimEngine(TOP, PA, device="cpu")
    spec = QuerySpec(origins=(3,), rng="independent")
    engine.run(spec, "fd-dynamic")
    sl = next(iter(engine.plan._slices.values()))
    levels, els, rr = _device_slices(sl, engine.device)
    assert rr is None and not sl.reroute
    assert engine.run(spec, "fd-dynamic").compile_s == 0.0
    pol = get_policy("fd-dynamic").variant(lifetime_mean_s=LIFETIME)
    cold = engine.run(spec, pol)
    assert cold.compile_s > 0.0 and sl.reroute
    warm = engine.run(spec, pol)
    assert warm.compile_s == 0.0
    again = _device_slices(sl, engine.device)
    assert again[0] is levels and again[1] is els and again[2] is not None
    assert not any(f.startswith("rr_") for lv in levels for f in lv)
    # non-dynamic churn and CN need no reroute tables: no compile either
    for name in ("fd-st1+2", "cn"):
        p_ = get_policy(name).variant(lifetime_mean_s=LIFETIME)
        engine.run(spec, p_)
        assert engine.run(spec, p_).compile_s == 0.0, name
    assert engine.plan.cache_info()["depth_slices"] == 2
    np.testing.assert_array_equal(cold.values, warm.values)
