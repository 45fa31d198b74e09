"""The port's overlay, NetworkPlan and DepthSlices against the reference
package's, array for array, on an overlay carried across.

The reference builds ``barabasi_albert(220, m=2, seed=7)``; its
``Topology`` fields cross to the port through ``topology_from_arrays``.
Every per-topology array, every per-origin static and every level field
of the depth slices (fold schedules included) must be identical, for
several origins and all three forward strategies.
"""
import numpy as np
import pytest

from repro.engine.plan import NetworkPlan as RefPlan
from repro.engine.plan import resolve_index_dtype as ref_resolve
from repro.p2psim.graph import barabasi_albert as ref_ba
from repro_torch.engine.plan import NetworkPlan, resolve_index_dtype
from repro_torch.p2psim import barabasi_albert, topology_from_arrays

REF_TOP = ref_ba(220, m=2, seed=7)
TOP = topology_from_arrays(REF_TOP.n, REF_TOP.neighbors, REF_TOP.kind)
ORIGINS = (0, 17, 101)

_TOPO_FIELDS = ("indptr", "indices", "e_src", "e_dst", "edge_keys",
                "degrees")
_STATIC_ARRAYS = ("parent", "depth", "reached", "rank", "idx", "ttl_rem",
                  "kid_sorted", "kid_ptr")
_STATIC_SCALARS = ("ttl", "origin", "n_edges_pq", "avg_degree", "m_basic")


def _eq(a, b, what):
    """Equal arrays of equal dtype, or equal nested tuples of them."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for j, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{j}]")
        return
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_carried_overlay_and_generator_match_reference():
    """``topology_from_arrays`` keeps every adjacency list, and the
    port's own generator draws the same overlay from the same seed."""
    own = barabasi_albert(220, m=2, seed=7)
    for top in (TOP, own):
        assert top.n == REF_TOP.n and top.kind == REF_TOP.kind
        assert top.n_edges == REF_TOP.n_edges
        for u in range(top.n):
            _eq(top.neighbors[u], REF_TOP.neighbors[u], f"neighbors[{u}]")
    with pytest.raises(ValueError, match="adjacency lists"):
        topology_from_arrays(5, REF_TOP.neighbors[:4])


@pytest.mark.parametrize("strategy", ["basic", "st1", "st1+2"])
def test_plan_statics_and_depth_slices_match_reference(strategy):
    ref, port = RefPlan(REF_TOP), NetworkPlan(TOP)
    assert port.index_dtype == ref.index_dtype == np.int32
    for f in _TOPO_FIELDS:
        _eq(getattr(port, f), getattr(ref, f), f)
    origins = np.asarray(ORIGINS)
    sts_r, q_r = ref.origin_statics(origins, 0, strategy)
    sts_p, q_p = port.origin_statics(origins, 0, strategy)
    np.testing.assert_array_equal(q_p, q_r)
    for st_p, st_r in zip(sts_p, sts_r):
        ctx = f"origin {st_r.origin} {strategy}"
        for f in _STATIC_ARRAYS:
            _eq(getattr(st_p, f), getattr(st_r, f), f"{ctx}: {f}")
        for f in _STATIC_SCALARS:
            assert getattr(st_p, f) == getattr(st_r, f), (ctx, f)
        _eq(tuple(st_p.levels), tuple(st_r.levels), f"{ctx}: levels")
        if strategy != "basic":
            assert st_p.fw_static == st_r.fw_static, ctx
            for f in ("fw_els_src", "fw_els_dst", "fw_cond"):
                _eq(getattr(st_p, f), getattr(st_r, f), f"{ctx}: {f}")
        assert port.auto_ttl(st_p.origin) == ref.auto_ttl(st_r.origin)
        sl_p, sl_r = port.depth_slices(st_p), ref.depth_slices(st_r)
        assert sl_p.dmax == sl_r.dmax and sl_p.n_els == sl_r.n_els, ctx
        for f in ("els_src", "els_dst", "cond"):
            _eq(getattr(sl_p, f), getattr(sl_r, f), f"{ctx}: {f}")
        for d, (lv_p, lv_r) in enumerate(zip(sl_p.levels, sl_r.levels)):
            assert sorted(lv_p) == sorted(lv_r), (ctx, d)
            for f in lv_r:
                _eq(lv_p[f], lv_r[f], f"{ctx}: level {d} {f}")
    assert port.cache_info() == ref.cache_info()


@pytest.mark.parametrize("strategy", ["st1", "st1+2"])
def test_classify_edges_matches_reference_and_full_pass(strategy):
    """The per-position edge classifier equals the reference's on a
    subset of positions, and over every position reproduces the full
    pass's ``fw_static`` / ``fw_els_*``."""
    ref, port = RefPlan(REF_TOP), NetworkPlan(TOP)
    st_r = ref.origin_statics(np.asarray([17]), 0, strategy)[0][0]
    st_p = port.origin_statics(np.asarray([17]), 0, strategy)[0][0]
    n = TOP.n
    rng = np.random.default_rng(3)
    sub = np.sort(rng.choice(len(port.e_src), 97, replace=False))
    for pos in (sub, np.arange(len(port.e_src))):
        args = (pos, port.e_src, port.e_dst, port.edge_keys, n,
                st_p.parent, st_p.depth, st_p.reached, st_p.ttl_rem)
        got = st_p._classify_edges(*args)
        want = st_r._classify_edges(*args)
        for j, (a, b) in enumerate(zip(got, want)):
            _eq(a, b, f"{strategy} classify[{j}]")
    u, v, unreach, tree, els = got
    assert int(unreach.sum() + tree.sum()) == st_p.fw_static
    np.testing.assert_array_equal(u[els], st_p.fw_els_src)
    np.testing.assert_array_equal(v[els], st_p.fw_els_dst)


def test_replica_table_and_index_dtype_guards_match_reference():
    from repro.p2psim.simulate import SimParams as RefParams
    from repro_torch.p2psim import SimParams
    ref, port = RefPlan(REF_TOP), NetworkPlan(TOP)
    for r, place in ((2, "random"), (3, "neighbor")):
        kw = dict(replication_factor=r, replication_placement=place)
        _eq(port.replica_table(SimParams(**kw)),
            ref.replica_table(RefParams(**kw)), f"replicas {r} {place}")
    assert port.replica_table(SimParams()) is None
    for n, nnz, req in ((100, 400, "auto"), (2**31, 10, "auto"),
                        (100, 400, "int64"), (100, 400, "int32")):
        assert resolve_index_dtype(n, nnz, req) == ref_resolve(n, nnz, req)
    with pytest.raises(ValueError, match="int32"):
        resolve_index_dtype(2**31, 10, "int32")
    with pytest.raises(ValueError, match="index_dtype"):
        NetworkPlan(TOP, index_dtype="int16")


@pytest.mark.parametrize("strategy", ["basic", "st1+2"])
def test_reroute_tables_match_reference(strategy):
    """``depth_slices(st, reroute=True)`` gives the reference's §4.2
    reroute tables, whether built with the slices or extended onto a
    cached instance whose static device tensors were uploaded already —
    those stay as they were, and the reroute tables upload apart."""
    import torch
    from repro_torch.engine.sim_torch import _device_slices
    ref = RefPlan(REF_TOP)
    built, extended = NetworkPlan(TOP), NetworkPlan(TOP)
    cpu = torch.device("cpu")
    for o in ORIGINS:
        st_r = ref.origin_statics(np.asarray([o]), 0, strategy)[0][0]
        sl_r = ref.depth_slices(st_r, reroute=True)
        st_b = built.origin_statics(np.asarray([o]), 0, strategy)[0][0]
        st_e = extended.origin_statics(np.asarray([o]), 0, strategy)[0][0]
        sl_e = extended.depth_slices(st_e)
        levels, els, rr = _device_slices(sl_e, cpu)
        assert rr is None and not sl_e.reroute
        assert extended.depth_slices(st_e, reroute=True) is sl_e
        for sl_p in (built.depth_slices(st_b, reroute=True), sl_e):
            assert sl_p.reroute and sl_r.reroute
            for d, (lv_p, lv_r) in enumerate(zip(sl_p.levels,
                                                 sl_r.levels)):
                assert sorted(lv_p) == sorted(lv_r), (o, d)
                for f in lv_r:
                    _eq(lv_p[f], lv_r[f], f"origin {o}: level {d} {f}")
        again = _device_slices(sl_e, cpu)
        assert again[0] is levels and again[1] is els
        assert not any(f.startswith("rr_") for lv in levels for f in lv)
        rr = again[2]
        assert len(rr) == sl_e.dmax + 1
        for d, r in enumerate(rr):
            if "rr_rounds" not in sl_e.levels[d]:
                assert r is None, (o, d)
                continue
            np.testing.assert_array_equal(
                r["gc_pos"].numpy(), sl_e.levels[d]["rr_gc_pos"])
            assert len(r["rounds"]) == len(sl_e.levels[d]["rr_rounds"])
    assert extended.cache_info() == built.cache_info() == ref.cache_info()
