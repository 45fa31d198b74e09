"""The port's topology registry and per-edge latencies on the CPU against
the reference package, bit for bit.

Mirrors tests/test_topologies.py: every registered family, built by the
port from a name, size and seed, equals the reference's (adjacency and
coordinates); the plan's per-edge latencies and each origin's tree-edge
latencies equal the reference's; ``_latency_mode`` refuses what the
reference refuses; and with ``latency_model="edge"`` the port's
``SimEngine(device="cpu")`` gives the reference ``SimEngine``'s bits
(values, indices, every ``BatchMetrics`` field) for FD, churn and CN* in
every RNG mode.
"""
import dataclasses

import numpy as np
import pytest

import repro.engine as ref_engine
from repro.engine.plan import NetworkPlan as RefPlan
from repro.p2psim import SimParams as RefParams
from repro.p2psim import run_query_reference as ref_run_query
from repro.p2psim import topologies as ref_topologies
from repro.p2psim.simulate import _latency_mode as ref_latency_mode
from repro_torch.engine import NetworkPlan, QuerySpec, SimEngine, get_policy
from repro_torch.p2psim import (SimParams, TopologySpec, Topology,
                                available_topologies, barabasi_albert,
                                build_topology, get_topology,
                                random_regular, register_topology,
                                topology_from_arrays)
from repro_torch.p2psim.simulate import _latency_mode

FAMILIES = ref_topologies.available_topologies()
FIELDS = ("n_reached", "n_edges_pq", "avg_degree", "m_fw", "b_fw", "m_bw",
          "m_rt", "b_bw", "b_rt", "response_time_s", "accuracy")
# the reference's hierarchical test overlay, cut to a few hundred peers
REF_HTOP = ref_topologies.hierarchical(300, seed=3)
HTOP = build_topology("hierarchical", 300, seed=3)
REF_EDGE = RefParams(seed=11, k=7, latency_model="edge")
PA_EDGE = SimParams(**dataclasses.asdict(REF_EDGE))


def _ref_spec(spec):
    return ref_engine.QuerySpec(**{f.name: getattr(spec, f.name)
                                   for f in dataclasses.fields(spec)})


def _ref_policy(pol):
    return ref_engine.Policy(**{f.name: getattr(pol, f.name)
                                for f in dataclasses.fields(pol)})


def _assert_same(port, ref, ctx):
    assert port.backend_used == "sim-torch", ctx
    assert (port.topology, port.latency_model) == (ref.topology,
                                                   ref.latency_model), ctx
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port.metrics, f),
                                      getattr(ref.metrics, f),
                                      err_msg=f"{ctx}: {f}")
    np.testing.assert_array_equal(port.values, ref.values,
                                  err_msg=f"{ctx}: values")
    np.testing.assert_array_equal(port.indices, ref.indices,
                                  err_msg=f"{ctx}: indices")


def _assert_same_topology(port, ref):
    assert (port.n, port.kind) == (ref.n, ref.kind)
    assert (port.lat_base_s, port.lat_scale_s) == (ref.lat_base_s,
                                                   ref.lat_scale_s)
    assert len(port.neighbors) == len(ref.neighbors)
    for a, b in zip(port.neighbors, ref.neighbors):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if ref.coords is None:
        assert port.coords is None
    else:
        assert port.coords.dtype == ref.coords.dtype
        assert np.array_equal(port.coords, ref.coords)


def test_registry_surface():
    assert available_topologies() == FAMILIES
    for name in FAMILIES:
        spec, ref = get_topology(name), ref_topologies.get_topology(name)
        assert spec.name == ref.name and spec.regime == ref.regime
        assert dict(spec.defaults) == dict(ref.defaults)
    assert get_topology(get_topology("ba")) is get_topology("ba")
    with pytest.raises(KeyError, match="unknown topology"):
        get_topology("torus")
    with pytest.raises(ValueError, match="already registered"):
        register_topology(TopologySpec("ba", barabasi_albert, regime="x"))


@pytest.mark.parametrize("name", FAMILIES)
def test_family_matches_reference(name):
    """Same name, size and seed: the same overlay, adjacency and
    coordinates bit for bit (the generators share the RNG streams)."""
    for n, seed in ((150, 4), (257, 11)):
        _assert_same_topology(build_topology(name, n, seed=seed),
                              ref_topologies.build_topology(name, n,
                                                            seed=seed))
    # overrides of the defaults travel the same way
    kw = {"ba": {"m": 3}, "waxman": {"alpha": 0.3},
          "hierarchical": {"n_as": 5}, "gnutella": {"rewire_p": 0.3},
          "small-world": {"k_ring": 6}, "random-regular": {"d": 6}}[name]
    _assert_same_topology(build_topology(name, 120, seed=2, **kw),
                          ref_topologies.build_topology(name, 120, seed=2,
                                                        **kw))


def test_random_regular_validation():
    for kw in ({"n": 10, "d": 3}, {"n": 4, "d": 4}, {"n": 10, "d": 0}):
        with pytest.raises(ValueError):
            random_regular(**kw)
        with pytest.raises(ValueError):
            ref_topologies.random_regular(**kw)


def test_latency_mode_errors_match_reference():
    ba, ref_ba = barabasi_albert(40, seed=1), ref_topologies.build_topology(
        "ba", 40, seed=1)
    for top, ref_top, lm in ((ba, ref_ba, "edge"), (HTOP, REF_HTOP, "nope"),
                             (HTOP, REF_HTOP, "Edge")):
        with pytest.raises(ValueError) as got:
            _latency_mode(top, SimParams(latency_model=lm))
        with pytest.raises(ValueError) as want:
            ref_latency_mode(ref_top, RefParams(latency_model=lm))
        assert (str(got.value).split(";")[0]
                == str(want.value).split(";")[0])
    assert _latency_mode(HTOP, PA_EDGE) is True
    assert _latency_mode(ba, SimParams()) is False
    # the engine refuses both before anything runs
    with pytest.raises(ValueError, match="coordinates"):
        SimEngine(ba, device="cpu").run(
            QuerySpec(origins=(0,), latency_model="edge"))
    with pytest.raises(ValueError, match="latency_model"):
        SimEngine(HTOP, SimParams(latency_model="Edge"),
                  device="cpu").run(QuerySpec())


def test_pair_latency_and_plan_alignment_match_reference():
    plan, ref_plan = NetworkPlan(HTOP), RefPlan(REF_HTOP)
    assert np.array_equal(plan.edge_lat, ref_plan.edge_lat)
    np.testing.assert_array_equal(HTOP.pair_latency(np.arange(9), 4),
                                  REF_HTOP.pair_latency(np.arange(9), 4))
    for o in (0, 17):
        st = plan.origin_statics(np.array([o]), 0, "st1+2")[0][0]
        rst = ref_plan.origin_statics(np.array([o]), 0, "st1+2")[0][0]
        assert np.array_equal(st.par_lat, rst.par_lat)
        assert np.array_equal(st.origin_lat, rst.origin_lat)
    assert NetworkPlan(barabasi_albert(40)).edge_lat is None
    with pytest.raises(ValueError):
        barabasi_albert(40).pair_latency(0, 1)


@pytest.mark.parametrize("name,lifetime", [
    ("fd-st1+2", None), ("fd-dynamic", None), ("cn-star", None),
    ("fd-dynamic", 25.0),                     # churn draws shift position
])
def test_edge_latency_parity_with_reference(name, lifetime):
    """With latency_model="edge" the port reproduces the reference's
    scalar run (shared batch of one), its numpy engine entry-wise
    (independent streams) and as a whole (shared stream, batch > 1)."""
    pol = get_policy(name)
    if lifetime is not None:
        pol = pol.variant(lifetime_mean_s=lifetime)
    port = SimEngine(HTOP, PA_EDGE, device="cpu")
    ref = ref_engine.SimEngine(REF_HTOP, REF_EDGE)
    kw = {"algorithm": pol.algorithm, "strategy": pol.strategy,
          "dynamic": pol.dynamic,
          "lifetime_mean_s": pol.lifetime_mean_s}
    met, _ = ref_run_query(REF_HTOP, 5, dataclasses.replace(REF_EDGE,
                                                            seed=2), **kw)
    res = port.run(QuerySpec(origins=(5,), seed=2), pol)
    assert dataclasses.asdict(res.query_metrics(0, 0)) == \
        dataclasses.asdict(met)
    for spec in (QuerySpec(origins=(0, 7), n_trials=2, rng="independent"),
                 QuerySpec(origins=(1, 8), n_trials=3)):
        _assert_same(port.run(spec, pol),
                     ref.run(_ref_spec(spec), _ref_policy(pol)),
                     f"{name}@{lifetime} {spec.rng}")


@pytest.mark.parametrize("family", ("ba", "small-world", "random-regular",
                                    "gnutella", "waxman"))
def test_every_family_matches_reference(family):
    """Every other family, under its native latency model ("iid" for
    embedding-free BA), in both RNG modes."""
    n = 120 if family == "waxman" else 200
    ref_top = ref_topologies.build_topology(family, n, seed=4)
    top = topology_from_arrays(ref_top.n, ref_top.neighbors, ref_top.kind,
                               ref_top.coords)
    lm = "iid" if top.coords is None else "edge"
    ref_p = RefParams(seed=11, k=7, latency_model=lm)
    port = SimEngine(top, SimParams(**dataclasses.asdict(ref_p)),
                     device="cpu")
    ref = ref_engine.SimEngine(ref_top, ref_p)
    for spec in (QuerySpec(origins=(0, 1), n_trials=2, rng="independent"),
                 QuerySpec(origins=(0, 1), n_trials=2)):
        _assert_same(port.run(spec), ref.run(_ref_spec(spec)),
                     f"{family}/{spec.rng}")


def test_latency_model_result_fields():
    """The model is recorded, the QuerySpec override beats the engine's
    SimParams, and the two models give different answers."""
    port = SimEngine(HTOP, SimParams(seed=11), device="cpu")
    r_iid = port.run(QuerySpec(origins=(0,)))
    r_edge = port.run(QuerySpec(origins=(0,), latency_model="edge"))
    assert (r_iid.topology, r_iid.latency_model) == ("hierarchical", "iid")
    assert r_edge.latency_model == "edge"
    assert (r_iid.metrics.response_time_s[0, 0]
            != r_edge.metrics.response_time_s[0, 0])
    direct = SimEngine(HTOP, dataclasses.replace(
        SimParams(seed=11), latency_model="edge"), device="cpu")
    assert (direct.run(QuerySpec(origins=(0,))).metrics.response_time_s
            == r_edge.metrics.response_time_s).all()
    assert isinstance(HTOP, Topology) and HTOP.coords is not None
