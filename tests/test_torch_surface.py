"""The port's package surface and its retired shims, on the CPU.

  * every name of the reference's two ``_ENGINE_EXPORTS``
    (``repro`` and ``repro.p2psim``) resolves on ``repro_torch`` /
    ``repro_torch.p2psim`` to the port's object in
    ``repro_torch.engine``;
  * mirrors tests/test_serving.py: the shims ``run_query``,
    ``run_queries`` and ``run_statistics_heuristic`` raise without
    ``REPRO_LEGACY_API=1`` and warn and delegate with it;
  * mirrors tests/test_engine.py::test_sim_engine_matches_legacy_shims:
    under the escape hatch each port shim (``device="cpu"``) returns the
    reference shim's float64 bits, for every standard policy.
"""
import dataclasses

import numpy as np
import pytest

import repro
import repro.p2psim as ref_p2psim
import repro_torch
import repro_torch.engine as engine
import repro_torch.p2psim as p2psim
from repro.p2psim import SimParams as RefParams
from repro.p2psim import barabasi_albert as ref_ba
from repro_torch.engine import QuerySpec, SimEngine, available_policies
from repro_torch.engine import get_policy
from repro_torch.p2psim import (SimParams, run_queries, run_query,
                                run_query_reference, run_statistics_heuristic,
                                topology_from_arrays)

REF_TOP = ref_ba(220, m=2, seed=7)
REF_PA = RefParams(seed=11)
TOP = topology_from_arrays(REF_TOP.n, REF_TOP.neighbors, REF_TOP.kind)
PA = SimParams(**dataclasses.asdict(REF_PA))
STANDARD = [n for n in available_policies() if n != "fd-stats"]
BM_FIELDS = ("n_reached", "n_edges_pq", "avg_degree", "m_fw", "m_bw",
             "m_rt", "b_fw", "b_bw", "b_rt", "response_time_s", "accuracy")


def _legacy_kwargs(pol):
    kw = dict(algorithm=pol.algorithm, strategy=pol.strategy,
              dynamic=pol.dynamic)
    if not np.isinf(pol.lifetime_mean_s):
        kw["lifetime_mean_s"] = pol.lifetime_mean_s
    return kw


# --------------------------------------------------------------------------
# lazy engine names
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", repro._ENGINE_EXPORTS)
def test_package_resolves_the_reference_engine_names(name):
    obj = getattr(repro_torch, name)
    assert obj is getattr(engine, name)
    assert obj.__module__.startswith("repro_torch."), obj.__module__
    assert name in repro_torch.__all__


@pytest.mark.parametrize("name", ref_p2psim._ENGINE_EXPORTS)
def test_p2psim_resolves_the_reference_engine_names(name):
    obj = getattr(p2psim, name)
    assert obj is getattr(engine, name)
    assert obj.__module__.startswith("repro_torch."), obj.__module__


def test_surface_keeps_its_names_and_refuses_unknown_ones():
    assert set(repro._ENGINE_EXPORTS) == set(repro_torch._ENGINE_EXPORTS)
    assert set(ref_p2psim._ENGINE_EXPORTS) == set(p2psim._ENGINE_EXPORTS)
    for name in ("DeviceEngine", "make_mesh", "local_topk"):
        assert name in repro_torch.__all__
    for mod in (repro_torch, p2psim):
        with pytest.raises(AttributeError, match="no attribute"):
            getattr(mod, "NoSuchEngine")
    for name in ("run_query", "run_queries", "run_statistics_heuristic"):
        assert hasattr(ref_p2psim, name) and hasattr(p2psim, name)


# --------------------------------------------------------------------------
# deprecated shims
# --------------------------------------------------------------------------

def test_legacy_shims_raise_without_escape_hatch(monkeypatch):
    monkeypatch.delenv("REPRO_LEGACY_API", raising=False)
    with pytest.raises(RuntimeError, match="REPRO_LEGACY_API"):
        run_query(TOP, 0, PA, device="cpu")
    with pytest.raises(RuntimeError, match="REPRO_LEGACY_API"):
        run_queries(TOP, [0], PA, 1, device="cpu")
    with pytest.raises(RuntimeError, match="REPRO_LEGACY_API"):
        run_statistics_heuristic(TOP, 0, PA, 0.8, device="cpu")


def test_legacy_shims_warn_and_delegate_under_escape_hatch(monkeypatch):
    monkeypatch.setenv("REPRO_LEGACY_API", "1")
    with pytest.warns(DeprecationWarning, match="SimEngine"):
        met, state = run_query(TOP, 0, PA, device="cpu")
    assert state is None
    with pytest.warns(DeprecationWarning, match="QuerySpec"):
        bm = run_queries(TOP, [0], PA, 1, device="cpu")
    with pytest.warns(DeprecationWarning, match="fd-stats"):
        full, pruned, red, acc = run_statistics_heuristic(
            TOP, 0, PA, 0.8, device="cpu")
    # the escape hatch must not change bits: shim == engine
    res = SimEngine(TOP, PA, device="cpu").run(QuerySpec(origins=(0,)),
                                               "fd-dynamic")
    assert res.query_metrics(0, 0) == met
    np.testing.assert_array_equal(bm.m_fw, res.metrics.m_fw)
    st = SimEngine(TOP, PA, device="cpu").run(
        QuerySpec(origins=(0,)), get_policy("fd-stats").variant(z=0.8))
    assert (full, pruned) == (st.extras["metrics_full"],
                              st.extras["metrics_pruned"])
    assert (red, acc) == (st.extras["comm_reduction"],
                          st.extras["accuracy"])


def test_shims_run_on_the_cuda_default_unless_told(monkeypatch):
    monkeypatch.setenv("REPRO_LEGACY_API", "1")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.warns(DeprecationWarning):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_queries(TOP, [0], PA, 1)


def test_run_query_state_variants_run_the_reference(monkeypatch):
    monkeypatch.setenv("REPRO_LEGACY_API", "1")
    mask = np.ones(TOP.n, bool)
    mask[5] = False
    with pytest.warns(DeprecationWarning):
        met, state = run_query(TOP, 3, PA, child_mask=mask,
                               return_state=True)
    ref, ref_state = run_query_reference(TOP, 3, PA, child_mask=mask,
                                         return_state=True)
    assert met == ref
    np.testing.assert_array_equal(state["reached"], ref_state["reached"])


@pytest.mark.parametrize("name", STANDARD)
def test_port_shims_match_the_reference_shims(name, monkeypatch):
    monkeypatch.setenv("REPRO_LEGACY_API", "1")   # retired shims re-enabled
    kw = _legacy_kwargs(get_policy(name))
    with pytest.warns(DeprecationWarning):
        bm = run_queries(TOP, [3, 12], PA, 2, device="cpu", **kw)
        ref_bm = ref_p2psim.run_queries(REF_TOP, [3, 12], REF_PA, 2, **kw)
    for f in BM_FIELDS:
        np.testing.assert_array_equal(getattr(bm, f), getattr(ref_bm, f),
                                      err_msg=f"{name}: {f}")
    with pytest.warns(DeprecationWarning):
        met, _ = run_query(TOP, 3, PA, device="cpu", **kw)
        ref_met, _ = ref_p2psim.run_query(REF_TOP, 3, REF_PA, **kw)
    assert dataclasses.asdict(met) == dataclasses.asdict(ref_met)
    # and the engine's own answer: the scalar shim is a batch of ONE
    one = SimEngine(TOP, PA, device="cpu").run(QuerySpec(origins=(3,)),
                                               name)
    assert one.query_metrics(0, 0) == met


def test_statistics_shim_matches_the_reference_shim(monkeypatch):
    monkeypatch.setenv("REPRO_LEGACY_API", "1")
    with pytest.warns(DeprecationWarning):
        got = run_statistics_heuristic(TOP, 4, PA, 0.5, device="cpu")
        ref = ref_p2psim.run_statistics_heuristic(REF_TOP, 4, REF_PA, 0.5)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(ref[0])
    assert dataclasses.asdict(got[1]) == dataclasses.asdict(ref[1])
    assert got[2:] == ref[2:]
