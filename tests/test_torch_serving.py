"""The port's run_many batching and QueryServer on the CPU.

Mirrors tests/test_serving.py: fused ``run_many`` results are entry-wise
bit-exact with sequential ``run`` (and with the reference package), the
server serves bits identical to ``run`` with no failure, a warmed server
reports ``compile_s == 0`` on live dispatches, and an engine failure is
counted instead of hidden.
"""
import dataclasses

import numpy as np
import pytest

import repro.engine as ref_engine
from repro.p2psim import SimParams as RefParams
from repro.p2psim import barabasi_albert as ref_ba
from repro_torch.engine import QueryServer, QuerySpec, SimEngine, get_policy
from repro_torch.p2psim import SimParams, topology_from_arrays

REF_TOP = ref_ba(220, m=2, seed=7)
REF_PA = RefParams(seed=11)
TOP = topology_from_arrays(REF_TOP.n, REF_TOP.neighbors, REF_TOP.kind)
PA = SimParams(**dataclasses.asdict(REF_PA))
FIELDS = ("n_reached", "n_edges_pq", "avg_degree", "m_fw", "b_fw", "m_bw",
          "m_rt", "b_bw", "b_rt", "response_time_s", "accuracy")

# one spec per RNG mode: shared batch-of-1 and the independent/seeded
# modes coalesce; the shared multi-entry spec must run solo
MIXED_SPECS = [
    QuerySpec(origins=(0,), seed=3),                       # shared, 1 entry
    QuerySpec(origins=(17,), seed=9),                      # shared, 1 entry
    QuerySpec(origins=(5, 41), n_trials=2,
              rng="independent", seed=2),                  # independent
    QuerySpec(origins=(9,), n_trials=2, seeds=[[7, 19]]),  # seed grid
    QuerySpec(origins=(3, 12), n_trials=2, seed=5),        # shared multi
    QuerySpec(origins=(29,), seed=3),                      # shared, 1 entry
]
MIXED_POLS = ["fd-dynamic"] * 5 + ["fd-basic"]


def _same_bits(a, b, ctx):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a.metrics, f),
                                      getattr(b.metrics, f),
                                      err_msg=f"{ctx}: {f}")
    np.testing.assert_array_equal(a.values, b.values, err_msg=ctx)
    np.testing.assert_array_equal(a.indices, b.indices, err_msg=ctx)


def test_run_many_bit_exact_vs_sequential_and_reference():
    engine = SimEngine(TOP, PA, device="cpu")
    fused = engine.run_many(MIXED_SPECS, MIXED_POLS)
    ref = ref_engine.SimEngine(REF_TOP, REF_PA)
    for i, (spec, pol) in enumerate(zip(MIXED_SPECS, MIXED_POLS)):
        _same_bits(fused[i], engine.run(spec, pol), f"request {i}")
        rs = ref_engine.QuerySpec(**{f.name: getattr(spec, f.name)
                                     for f in dataclasses.fields(spec)})
        _same_bits(fused[i], ref.run(rs, pol), f"request {i} vs reference")
    sizes = [r.batch_size for r in fused]
    assert sizes[:4] == [4] * 4, sizes     # the coalescable fd-dynamic
    assert sizes[4] == 1 and sizes[5] == 1  # shared multi / lone policy


def test_server_serves_bits_identical_to_run():
    engine = SimEngine(TOP, PA, device="cpu")
    with QueryServer(engine) as server:
        handles = [server.submit(s, p)
                   for s, p in zip(MIXED_SPECS, MIXED_POLS)]
        results = [h.result(timeout=60) for h in handles]
        m = server.metrics()
    for i, (res, spec, pol) in enumerate(
            zip(results, MIXED_SPECS, MIXED_POLS)):
        _same_bits(res, engine.run(spec, pol), f"request {i}")
        assert res.backend_used == "sim-torch" and res.queue_s >= 0.0
    assert m.served == m.submitted == len(MIXED_SPECS)
    assert m.failed == 0


def test_warmed_server_dispatches_without_compile():
    engine = SimEngine(TOP, PA, device="cpu")
    server = QueryServer(engine)
    for o in (0, 1):
        server.warm(QuerySpec(origins=(o,), rng="independent"),
                    batch_sizes=(1, 8))
    handles = [server.submit(QuerySpec(origins=(i % 2,), seed=50 + i,
                                       rng="independent"))
               for i in range(8)]
    server.start()
    results = [h.result(timeout=60) for h in handles]
    server.stop()
    assert max(r.batch_size for r in results) > 1
    for r in results:
        assert r.compile_s == 0, (r.batch_size, r.compile_s)


def test_engine_failure_is_counted_not_hidden():
    """A request the engine refuses (fd-stats over two trials, which the
    reference refuses too) fails: the handle raises and the server's
    ``failed`` counter says so."""
    bad = QuerySpec(origins=(0,), n_trials=2)
    with pytest.raises(ValueError):
        ref_engine.SimEngine(REF_TOP, REF_PA).run(
            ref_engine.QuerySpec(origins=(0,), n_trials=2), "fd-stats")
    with QueryServer(SimEngine(TOP, PA, device="cpu")) as server:
        h = server.submit(bad, "fd-stats")
        with pytest.raises(ValueError, match="one origin x one trial"):
            h.result(timeout=60)
        m = server.metrics()
    assert m.failed == 1 and m.served == 0


@pytest.mark.parametrize("lifetime", [float("inf"), 60.0])
def test_run_many_mixed_fd_dynamic_and_cn_group_separately(lifetime):
    """Mirrors tests/test_serving.py's mixed-policy batch: fd-dynamic
    and cn requests fuse per policy, bit-exact with sequential ``run``
    and with the reference package, with and without churn."""
    engine = SimEngine(TOP, PA, device="cpu")
    ref = ref_engine.SimEngine(REF_TOP, REF_PA)
    specs = [QuerySpec(origins=(o,), seed=s)
             for s, o in enumerate((0, 7, 42, 3, 12, 9))]
    names = ["fd-dynamic", "cn"] * 3
    pols = [get_policy(n).variant(lifetime_mean_s=lifetime) for n in names]
    fused = engine.run_many(specs, pols)
    for i, (f, spec, pol) in enumerate(zip(fused, specs, pols)):
        _same_bits(f, engine.run(spec, pol), f"request {i}")
        rs = ref_engine.QuerySpec(**{fl.name: getattr(spec, fl.name)
                                     for fl in dataclasses.fields(spec)})
        rp = ref_engine.get_policy(names[i]).variant(
            lifetime_mean_s=lifetime)
        _same_bits(f, ref.run(rs, rp), f"request {i} vs reference")
        assert f.policy == names[i] and f.batch_size == 3


def test_warmed_server_serves_churn_and_baselines():
    """A server warmed per policy serves churned fd-dynamic (reroute),
    fd-basic, cn and cn-star requests from several clients with no
    compile and no failure, each with ``run``'s bits."""
    engine = SimEngine(TOP, PA, device="cpu")
    pols = [get_policy(n).variant(lifetime_mean_s=60.0)
            for n in ("fd-dynamic", "fd-basic", "cn", "cn-star")]
    server = QueryServer(engine)
    for pol in pols:
        for o in (0, 1):
            server.warm(QuerySpec(origins=(o,), rng="independent"), pol,
                        batch_sizes=(1, 4))
    reqs = [(QuerySpec(origins=(i % 2,), seed=70 + i, rng="independent"),
             pols[i % len(pols)]) for i in range(12)]
    handles = [server.submit(s, p) for s, p in reqs]
    server.start()
    results = [h.result(timeout=60) for h in handles]
    server.stop()
    m = server.metrics()
    assert m.served == m.submitted == len(reqs) and m.failed == 0
    assert max(r.batch_size for r in results) > 1
    for i, (r, (spec, pol)) in enumerate(zip(results, reqs)):
        assert r.compile_s == 0, (i, r.batch_size, r.compile_s)
        assert r.backend_used == "sim-torch"
        _same_bits(r, engine.run(spec, pol), f"request {i}")
