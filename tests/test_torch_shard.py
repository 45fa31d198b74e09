"""Entry sharding (``SimEngine(shard=True)``) in the port on the CPU.

Mirrors tests/test_engine.py::test_sharded_sim_sweep_matches_numpy_bits:
12 independent entries (origins 0, 9, 23 x 4 trials) on a 150-peer
Barabási–Albert overlay, split into forced CPU chunks
(``_shard_devices``), give the reference numpy ``SimEngine``'s float64
bits and the port's unsharded bits (``values``, ``indices`` and every
``BatchMetrics`` field) under fd-basic, fd-st1 and fd-dynamic; in f32
the unsharded bits and the tolerance contract; under churn (lifetime
60 s, fd-dynamic, §4.2 reroute folded in each chunk) both.

The device choice itself: ``shard=True`` takes every local CUDA device,
ignores one, and is refused on the CPU without a forced list.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.engine as ref_engine
from repro.p2psim import SimParams as RefParams
from repro.p2psim import barabasi_albert as ref_ba
from repro_torch.engine import QuerySpec, SimEngine, get_policy
from repro_torch.engine.sim_torch import shard_devices
from repro_torch.p2psim import SimParams, topology_from_arrays

REF_TOP = ref_ba(150, m=2, seed=3)
REF_PA = RefParams(k=5, seed=7)
TOP = topology_from_arrays(REF_TOP.n, REF_TOP.neighbors, REF_TOP.kind)
PA = SimParams(**dataclasses.asdict(REF_PA))
SPEC = QuerySpec(origins=(0, 9, 23), n_trials=4, seed=7, rng="independent")
FIELDS = ("n_reached", "n_edges_pq", "avg_degree", "m_fw", "b_fw", "m_bw",
          "m_rt", "b_bw", "b_rt", "response_time_s", "accuracy")
CHURN = get_policy("fd-dynamic").variant(lifetime_mean_s=60.0)


def _ref_spec(spec):
    return ref_engine.QuerySpec(**{f.name: getattr(spec, f.name)
                                   for f in dataclasses.fields(spec)})


def _same_bits(a, b, ctx):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a.metrics, f),
                                      getattr(b.metrics, f),
                                      err_msg=f"{ctx}: {f}")
    np.testing.assert_array_equal(a.values, b.values, err_msg=ctx)
    np.testing.assert_array_equal(a.indices, b.indices, err_msg=ctx)


def _sharded(n_dev, **kw):
    return SimEngine(TOP, PA, device="cpu", shard=True,
                     _shard_devices=["cpu"] * n_dev, **kw)


@pytest.mark.parametrize("n_dev", [3, 8])
@pytest.mark.parametrize("pol", ["fd-basic", "fd-st1", "fd-dynamic"])
def test_sharded_sweep_matches_reference_and_unsharded_bits(pol, n_dev):
    rs = _sharded(n_dev).run(SPEC, pol)
    assert rs.backend_used == "sim-torch"
    _same_bits(rs, SimEngine(TOP, PA, device="cpu").run(SPEC, pol),
               f"{pol} on {n_dev} chunks vs unsharded")
    _same_bits(rs, ref_engine.SimEngine(REF_TOP, REF_PA).run(
        _ref_spec(SPEC), pol), f"{pol} on {n_dev} chunks vs reference")


def test_sharded_f32_keeps_the_unsharded_bits_and_tolerance():
    rs = _sharded(8, precision="f32").run(SPEC, "fd-dynamic")
    rn = SimEngine(TOP, PA, device="cpu", precision="f32").run(
        SPEC, "fd-dynamic")
    assert rs.precision == "f32"
    assert rs.extras["tolerance"]["ok"], rs.extras["tolerance"]
    assert rs.extras["tolerance"] == rn.extras["tolerance"]
    _same_bits(rs, rn, "f32 on 8 chunks vs unsharded")


def test_sharded_churn_folds_reroutes_in_every_chunk():
    rs = _sharded(8).run(SPEC, CHURN)
    _same_bits(rs, SimEngine(TOP, PA, device="cpu").run(SPEC, CHURN),
               "churn on 8 chunks vs unsharded")
    ref_pol = ref_engine.get_policy("fd-dynamic").variant(
        lifetime_mean_s=60.0)
    _same_bits(rs, ref_engine.SimEngine(REF_TOP, REF_PA).run(
        _ref_spec(SPEC), ref_pol), "churn on 8 chunks vs reference")
    assert (rs.metrics.m_bw < rs.metrics.n_reached - 1).any()  # deaths


def test_baselines_and_a_warm_plan_under_shard():
    eng = _sharded(8)
    for pol in ("cn", "cn-star"):        # never split, same bits
        _same_bits(eng.run(SPEC, pol),
                   SimEngine(TOP, PA, device="cpu").run(SPEC, pol), pol)
    first = eng.run(SPEC, "fd-dynamic")
    again = eng.run(SPEC, "fd-dynamic")
    assert again.compile_s == 0.0        # slices uploaded once per device
    _same_bits(first, again, "warm rerun")


def test_shard_devices_takes_every_cuda_device_and_ignores_one(monkeypatch):
    cuda = torch.device("cuda")
    assert shard_devices(cuda, False) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert shard_devices(cuda, True) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert shard_devices(cuda, True) == tuple(
        torch.device("cuda", i) for i in range(4))
    assert shard_devices(cuda, True, ["cuda:0"] * 2) == (
        torch.device("cuda", 0),) * 2


def test_shard_is_refused_on_the_cpu_without_a_device_list():
    with pytest.raises(ValueError, match="CUDA devices"):
        SimEngine(TOP, PA, device="cpu", shard=True)
    with pytest.raises(ValueError, match="empty"):
        SimEngine(TOP, PA, device="cpu", shard=True, _shard_devices=[])
    # shard=False ignores a forced list
    assert SimEngine(TOP, PA, device="cpu",
                     _shard_devices=["cpu"] * 2)._shard is None
