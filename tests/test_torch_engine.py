"""The port's SimEngine on the CPU against the reference package's, bit
for bit, on overlays carried across.

Mirrors tests/test_engine.py (every FD policy without churn, in every
RNG mode; k = 7 with explicit seeds) and tests/test_properties.py
(random overlays).  The reference engines run numpy (and, once, jax);
the port runs ``device="cpu"``, where each kernel call takes its plain
PyTorch version.  Every comparison is exact: ``values``, ``indices`` and
every ``BatchMetrics`` field.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.engine as ref_engine
from repro.p2psim import SimParams as RefParams
from repro.p2psim import barabasi_albert as ref_ba
from repro.p2psim import run_query_reference
from repro.engine.precision import check_tolerance as ref_check_tolerance
from repro.p2psim.topologies import hierarchical as ref_hierarchical
from repro_torch.engine import QuerySpec, SimEngine, get_policy
from repro_torch.p2psim import SimParams, topology_from_arrays

POLICIES = ("fd-basic", "fd-st1", "fd-st1+2", "fd-dynamic")
FIELDS = ("n_reached", "n_edges_pq", "avg_degree", "m_fw", "b_fw", "m_bw",
          "m_rt", "b_bw", "b_rt", "response_time_s", "accuracy")
REF_TOP = ref_ba(220, m=2, seed=7)
REF_PA = RefParams(seed=11)


def _carry(ref_top):
    return topology_from_arrays(ref_top.n, ref_top.neighbors, ref_top.kind)


def _params(ref_params):
    return SimParams(**dataclasses.asdict(ref_params))


TOP = _carry(REF_TOP)
PA = _params(REF_PA)


def _ref_spec(spec):
    return ref_engine.QuerySpec(**{f.name: getattr(spec, f.name)
                                   for f in dataclasses.fields(spec)})


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


SPECS = {
    "shared-1": QuerySpec(origins=(5,), seed=2),
    "shared-many": QuerySpec(origins=(1, 8), n_trials=3),
    "independent": QuerySpec(origins=(0, 7, 7), n_trials=2,
                             rng="independent"),
    "seeds": QuerySpec(origins=(0, 9), n_trials=2,
                       seeds=np.array([[101, 202], [303, 404]])),
}


@pytest.mark.parametrize("name", POLICIES)
def test_port_matches_reference_every_rng_mode(name):
    port = SimEngine(TOP, PA, device="cpu")
    ref = ref_engine.SimEngine(REF_TOP, REF_PA)
    for mode, spec in SPECS.items():
        _assert_same(port.run(spec, name), ref.run(_ref_spec(spec), name),
                     f"{name}/{mode}")


def test_port_nonpow2_k_and_explicit_seeds_is_reference():
    """k = 7 (lists padded to K = 8) with an explicit seed grid: every
    entry equals the scalar reference on its seed."""
    seeds = np.array([[11, 22], [33, 44]])
    spec = QuerySpec(origins=(0, 9), n_trials=2, k=7, seeds=seeds)
    res = SimEngine(TOP, PA, device="cpu").run(spec, "fd-st1+2")
    assert res.k == 7 and res.values.shape == (2, 2, 7)
    for q, o in enumerate((0, 9)):
        for t in range(2):
            met, _ = run_query_reference(
                REF_TOP, o,
                dataclasses.replace(REF_PA, k=7, seed=int(seeds[q, t])),
                strategy="st1+2", dynamic=False)
            assert res.query_metrics(q, t).as_dict() == met.as_dict()
    ref = ref_engine.SimEngine(REF_TOP, REF_PA).run(_ref_spec(spec),
                                                    "fd-st1+2")
    _assert_same(res, ref, "k=7")


@pytest.mark.parametrize("r,place", [(2, "random"), (3, "neighbor")])
def test_replicated_retrieval_matches_reference(r, place):
    """``replication_factor > 0`` runs: the plan builds the replica
    table and the retrieval epilogues take it.  Without churn no owner
    is dead, so every item is served by its owner and the bits are the
    reference's (and those of an unreplicated run)."""
    ref_p = dataclasses.replace(REF_PA, replication_factor=r,
                                replication_placement=place)
    port = SimEngine(TOP, _params(ref_p), device="cpu")
    ref = ref_engine.SimEngine(REF_TOP, ref_p)
    for mode in ("shared-many", "independent"):
        spec = SPECS[mode]
        _assert_same(port.run(spec, "fd-dynamic"),
                     ref.run(_ref_spec(spec), "fd-dynamic"),
                     f"replicas {r} {place}/{mode}")


def test_port_matches_jax_backend():
    ref_top = ref_ba(96, m=2, seed=3)
    spec = QuerySpec(origins=(0, 3), n_trials=2, rng="independent")
    rj = ref_engine.SimEngine(ref_top, REF_PA, backend="jax").run(
        _ref_spec(spec), "fd-dynamic")
    rp = SimEngine(_carry(ref_top), PA, device="cpu").run(spec,
                                                           "fd-dynamic")
    _assert_same(rp, rj, "jax backend")


@settings(max_examples=6, deadline=None)
@given(n=st.integers(12, 40), m=st.integers(1, 3),
       seed=st.integers(0, 10_000), pol=st.integers(0, len(POLICIES) - 1),
       rng=st.integers(0, 1))
def test_random_overlays_match_reference_bits(n, m, seed, pol, rng):
    ref_top = ref_ba(n, max(1, min(m, n - 1)), seed=seed)
    ref_p = RefParams(k=4, seed=seed + 1)
    spec = QuerySpec(origins=(0, n // 2), n_trials=2,
                     rng=("shared", "independent")[rng])
    port = SimEngine(_carry(ref_top), _params(ref_p), device="cpu")
    ref = ref_engine.SimEngine(ref_top, ref_p)
    _assert_same(port.run(spec, POLICIES[pol]),
                 ref.run(_ref_spec(spec), POLICIES[pol]),
                 f"n={n} m={m} seed={seed} {POLICIES[pol]}")


# a coordinate-carrying overlay, so the latency_model="edge" cases run
REF_HTOP = ref_hierarchical(220, seed=7)
HTOP = topology_from_arrays(REF_HTOP.n, REF_HTOP.neighbors, REF_HTOP.kind,
                            REF_HTOP.coords)


def _ref_policy(policy):
    if isinstance(policy, str):
        return policy
    return ref_engine.Policy(**{f.name: getattr(policy, f.name)
                                for f in dataclasses.fields(policy)})


@pytest.mark.parametrize("policy,spec", [
    (get_policy("fd-stats").variant(lifetime_mean_s=30.0), QuerySpec()),
    ("cn", QuerySpec(precision="f32")),
    ("fd-stats", QuerySpec()),
    ("cn-star", QuerySpec(latency_model="edge")),
    ("fd-dynamic", QuerySpec(latency_model="edge")),
    ("fd-dynamic", QuerySpec(precision="f32")),
    ("fd-basic", QuerySpec(precision="bf16")),
])
def test_unported_policies_and_options_raise(policy, spec):
    """The policies and options earlier slices of the port refused
    (fd-stats, per-edge latencies, f32 / bf16) now run and are held to
    the reference package: its bits in f64 (fd-stats: both rounds'
    metrics, the traffic cut and the accuracy), the tolerance contract
    against its f64 answer in f32 / bf16."""
    port = SimEngine(HTOP, PA, device="cpu")
    ref = ref_engine.SimEngine(REF_HTOP, REF_PA)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # fd-stats: host
        got = port.run(spec, policy)
    prec = spec.precision or "f64"
    want = ref.run(_ref_spec(dataclasses.replace(spec, precision=None)),
                   _ref_policy(policy))
    assert got.precision == prec and got.latency_model == want.latency_model
    if prec != "f64":
        assert got.extras["tolerance"]["ok"], got.extras["tolerance"]
        assert ref_check_tolerance(
            prec, *(a.reshape(-1, got.k) for a in (
                got.values, got.indices, want.values, want.indices))).ok
        return
    if got.policy.startswith("fd-stats"):
        assert got.backend_used == "sim" and want.backend_used == "sim"
        for key in ("metrics_full", "metrics_pruned"):
            assert (dataclasses.asdict(got.extras[key])
                    == dataclasses.asdict(want.extras[key])), key
        for key in ("comm_reduction", "accuracy", "z"):
            assert got.extras[key] == want.extras[key], key
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got.metrics, f),
                                          getattr(want.metrics, f),
                                          err_msg=f)
        return
    _assert_same(got, want, f"{got.policy} {spec}")


def test_overlay_and_device_resolution_raise(monkeypatch):
    """The port's live overlay is adopted and bound; the reference
    package's overlay is refused (carry it across with
    ``topology_from_arrays``); with no CUDA device and no explicit
    device the engine refuses to start instead of running on the
    CPU."""
    from repro.p2psim import Overlay as RefOverlay
    from repro_torch.p2psim import Overlay
    engine = SimEngine(device="cpu")
    ov = Overlay(TOP)
    assert engine.prepare(ov).overlay is ov
    with pytest.raises(TypeError, match="topology_from_arrays"):
        engine.prepare(RefOverlay(REF_TOP))
    with pytest.raises(TypeError, match="topology_from_arrays"):
        engine.prepare(REF_TOP.neighbors)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SimEngine(TOP, PA)


def test_warm_engine_reports_no_compile():
    engine = SimEngine(TOP, PA, device="cpu")
    spec = QuerySpec(origins=(3, 4), rng="independent")
    cold = engine.run(spec, "fd-dynamic")
    warm = engine.run(spec, "fd-dynamic")
    assert cold.compile_s > 0.0 and warm.compile_s == 0.0
    assert warm.run_s > 0.0 and warm.batch_size == 1
    assert engine.plan.cache_info()["depth_slices"] == 2
    np.testing.assert_array_equal(cold.values, warm.values)
