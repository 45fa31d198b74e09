"""Reduced precision (f32 / bf16) on the port's sim path, on the CPU.

Mirrors tests/test_properties.py's tolerance contract and
``repro.engine.precision``:

* the port's ``check_tolerance`` gives the reference's report on random,
  tied, empty and mismatched lists;
* ``host_cast`` narrows float64 draws to the reference's bits
  (``ml_dtypes`` for bf16, numpy for f32), half-ulp cases included;
* every policy, RNG mode and reduced precision meets the contract
  against the port's own f64 rerun (``extras["tolerance"]``), and the
  reference's ``check_tolerance`` passes on the port's answer against
  the reference's f64 answer;
* against ``SimEngine(backend="jax", precision=...)`` the port's values
  are within ``PRECISION_RTOL`` at every rank and its forward traffic
  is bit-equal; the port decides a late list once, in the sweep's
  dtype, where the reference also decides it in float64 (ROADMAP,
  Queue 3), so its answer holds each shared owner's f64 values cast.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.engine as ref_engine
from repro.engine.precision import check_tolerance as ref_check_tolerance
from repro.p2psim import SimParams as RefParams
from repro.p2psim import barabasi_albert as ref_ba
from repro_torch.engine import QuerySpec, SimEngine, get_policy
from repro_torch.engine.precision import (PRECISION_RTOL, check_tolerance,
                                          host_cast)
from repro_torch.engine.sim_torch import _cn_sweep, _one_dtype
from repro_torch.p2psim import SimParams, topology_from_arrays

POLICIES = ("fd-basic", "fd-st1", "fd-st1+2", "fd-dynamic", "cn", "cn-star",
            "fd-dynamic@25")
REF_TOP = ref_ba(120, m=2, seed=7)
TOP = topology_from_arrays(REF_TOP.n, REF_TOP.neighbors, REF_TOP.kind)
REF_PA = RefParams(seed=11, k=7)
PA = SimParams(**dataclasses.asdict(REF_PA))


def _policy(name, pkg):
    get = ref_engine.get_policy if pkg == "ref" else get_policy
    if name.endswith("@25"):
        return get(name[:-3]).variant(lifetime_mean_s=25.0)
    return get(name)


def _ref_spec(spec):
    return ref_engine.QuerySpec(**{f.name: getattr(spec, f.name)
                                   for f in dataclasses.fields(spec)})


# ---- the tolerance report --------------------------------------------------

def _cases():
    rng = np.random.default_rng(3)
    hi = -np.sort(-rng.random((5, 8)), axis=1)
    own = rng.permutation(40).reshape(5, 8)
    tied = np.repeat(hi[:, :4], 2, axis=1)
    empty = hi.copy()
    empty[:, 6:] = -np.inf
    own_e = own.copy()
    own_e[:, 6:] = -1
    return {
        "equal": (hi, own, hi, own),
        "rounded": (hi.astype(np.float32).astype(np.float64), own, hi, own),
        "coarse": (np.round(hi, 2), own, hi, own),
        "swapped owners": (hi, own[:, ::-1], hi, own),
        "ties": (tied, own[:, ::-1], tied, own),
        "empty slots": (empty, own_e, empty, own_e),
        "structural": (hi, own, empty, own_e),
        "near zero": (hi * 1e-7 + 1e-9, own, hi * 1e-7, own),
    }


@pytest.mark.parametrize("precision", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("case", sorted(_cases()))
def test_check_tolerance_matches_reference(precision, case):
    args = _cases()[case]
    got = check_tolerance(precision, *args).summary()
    want = ref_check_tolerance(precision, *args).summary()
    assert got == want
    assert got["rtol_bound"] == PRECISION_RTOL[precision]


def test_check_tolerance_errors_match_reference():
    a, b = np.zeros((2, 3)), np.zeros((2, 4))
    o = np.zeros((2, 3), np.int64)
    with pytest.raises(ValueError, match="shape mismatch"):
        check_tolerance("f32", a, o, b, o)
    with pytest.raises(ValueError, match="shape mismatch"):
        ref_check_tolerance("f32", a, o, b, o)


# ---- the one host cast -----------------------------------------------------

def _cast_inputs():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(200_000), rng.normal(0, 1e3, 50_000),
                        rng.random(50_000) * 1e-40])
    # bf16 half-ulp points and a hair either side, around [1, 8)
    b = (np.arange(0x3F80, 0x4100, dtype=np.uint32) << 16).view(np.float32)
    half = b.astype(np.float64) * (1 + 2.0 ** -9)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-300,
                         3.4e38, 3.5e38, -1e-45])
    return np.concatenate([x, half, np.nextafter(half, 0),
                           np.nextafter(half, 2), specials])


@pytest.mark.parametrize("precision,np_dtype,bits", [
    ("bf16", ml_dtypes.bfloat16, np.int16),
    ("f32", np.float32, np.int32),
])
def test_host_cast_matches_reference_bits(precision, np_dtype, bits):
    x = _cast_inputs()
    got = host_cast(x, precision)
    assert got.device.type == "cpu"
    assert got.dtype == {"bf16": torch.bfloat16, "f32": torch.float32}[
        precision]
    tbits = {np.int16: torch.int16, np.int32: torch.int32}[bits]
    assert np.array_equal(got.view(tbits).numpy(),
                          x.astype(np_dtype).view(bits))
    # f64 is the array itself, unconverted
    same = host_cast(x, "f64")
    assert same.dtype == torch.float64 and same.data_ptr() == \
        x.__array_interface__["data"][0]
    with pytest.raises(ValueError, match="precision"):
        host_cast(x, "f16")


# ---- the contract on the port's answers ------------------------------------

@settings(max_examples=8, deadline=None)
@given(n=st.integers(12, 32), seed=st.integers(0, 10_000),
       pol=st.integers(0, len(POLICIES) - 1), rng=st.integers(0, 1),
       prec=st.integers(0, 1))
def test_reduced_precision_tolerance_contract(n, seed, pol, rng, prec):
    precision = ("f32", "bf16")[prec]
    ref_top = ref_ba(n, 2, seed=seed)
    eng = SimEngine(topology_from_arrays(ref_top.n, ref_top.neighbors),
                    SimParams(k=4, seed=seed + 1), device="cpu",
                    precision=precision)
    res = eng.run(QuerySpec(origins=(0,), n_trials=2,
                            rng=("shared", "independent")[rng]),
                  _policy(POLICIES[pol], "port"))
    assert res.precision == precision
    assert res.values.dtype == np.float64       # widened exactly
    tol = res.extras["tolerance"]
    assert tol["ok"], f"{POLICIES[pol]}/{precision}: {tol}"
    assert tol["max_rtol"] <= PRECISION_RTOL[precision]
    if tol["separated"]:
        assert tol["recall"] == 1.0


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["shared", "independent"])
def test_reference_contract_holds_on_port_answers(precision, mode):
    """The reference's own check passes on the port's reduced answer
    against the reference's f64 answer, for every policy."""
    port = SimEngine(TOP, PA, device="cpu", precision=precision)
    ref = ref_engine.SimEngine(REF_TOP, REF_PA)
    spec = QuerySpec(origins=(0, 40), n_trials=2, rng=mode)
    for name in POLICIES:
        got = port.run(spec, _policy(name, "port"))
        want = ref.run(_ref_spec(spec), _policy(name, "ref"))
        lists = [a.reshape(-1, PA.k) for a in (got.values, got.indices,
                                               want.values, want.indices)]
        report = ref_check_tolerance(precision, *lists)
        assert report.ok, (name, report)
        assert got.extras["tolerance"]["ok"], name
        # the port's f64 rerun is the reference's f64 answer
        assert got.extras["tolerance"] == check_tolerance(
            precision, *lists).summary()


def _owners_hold_f64_cast(lo, hi, precision):
    """Each owner in both answers holds in the reduced one the cast of
    its own leading f64 values, in order (the cast is monotone, and a
    list is merged or sent urgent, never both); returns the slots held
    to that."""
    k = PA.k
    v_lo, o_lo = lo.values.reshape(-1, k), lo.indices.reshape(-1, k)
    v_hi, o_hi = hi.values.reshape(-1, k), hi.indices.reshape(-1, k)
    cast = host_cast(v_hi, precision).double().numpy()
    slots = 0
    for e in range(len(v_hi)):
        for o in np.intersect1d(o_lo[e][o_lo[e] >= 0], o_hi[e]):
            a, b = v_lo[e][o_lo[e] == o], cast[e][o_hi[e] == o]
            m = min(len(a), len(b))
            np.testing.assert_array_equal(a[:m], b[:m], err_msg=f"{e} {o}")
            slots += m
    return slots


@pytest.mark.parametrize("tuples", [None, (1, 3)])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_port_matches_reference_jax_backend(precision, tuples):
    """Against ``SimEngine(backend="jax", precision=...)``: forward
    traffic bit-equal, and values within PRECISION_RTOL at every rank
    where the top scores tie within that bound (many scores a peer).  The
    reference decides a late list in float64 on the reduced send times,
    apart from its sweep's on-time test in the reduced dtype, so a list
    whose arrival rounds onto its parent's send time is both merged and
    sent urgent (an item twice, a message too many); the port decides
    once, in the sweep's dtype (ROADMAP, Queue 3).  So each owner the
    port's answer shares with the reference's f64 answer holds its f64
    values cast, and in f32, where no arrival on this overlay lies
    within an ulp of its parent's send time, the port's backward traffic
    and values are the f64 run's, cast, bit for bit.  With 1-3 scores a
    peer the top scores stay apart, in bf16 too: owners are shared, and
    the reference's contract holds on the port's answer against its f64
    answer (the reference's own f32 answer, repeating items, fails it)."""
    few = {} if tuples is None else {"tuples_lo": tuples[0],
                                     "tuples_hi": tuples[1]}
    ref_pa = dataclasses.replace(REF_PA, **few)
    port = SimEngine(TOP, dataclasses.replace(PA, **few), device="cpu",
                     precision=precision, validate_precision=False)
    jx = ref_engine.SimEngine(REF_TOP, ref_pa, backend="jax",
                              precision=precision, validate_precision=False)
    f64 = ref_engine.SimEngine(REF_TOP, ref_pa)
    # one origin: each (policy, origin) is one jax trace to compile
    for name, mode in (("fd-dynamic", "independent"),
                       ("fd-dynamic@25", "shared")):
        spec = QuerySpec(origins=(0,), n_trials=3, rng=mode)
        got = port.run(spec, _policy(name, "port"))
        want = jx.run(_ref_spec(spec), _policy(name, "ref"))
        hi = f64.run(_ref_spec(spec), _policy(name, "ref"))
        assert want.precision == got.precision == precision
        for f in ("m_fw", "b_fw"):
            np.testing.assert_array_equal(getattr(got.metrics, f),
                                          getattr(want.metrics, f),
                                          err_msg=f"{name}: {f}")
        held = _owners_hold_f64_cast(got, hi, precision)
        if tuples is None:
            # the top scores lie within the bound of each other, so an
            # item the reference repeats moves no rank beyond it
            np.testing.assert_allclose(got.values, want.values, atol=0,
                                       rtol=PRECISION_RTOL[precision],
                                       err_msg=name)
        else:
            assert held > 0, name
            lists = [a.reshape(-1, PA.k) for a in (got.values, got.indices,
                                                   hi.values, hi.indices)]
            assert ref_check_tolerance(precision, *lists).ok, name
        if precision == "f32":
            for f in ("m_bw", "b_bw"):
                np.testing.assert_array_equal(getattr(got.metrics, f),
                                              getattr(hi.metrics, f),
                                              err_msg=f"{name}: {f}")
            np.testing.assert_array_equal(
                got.values, host_cast(hi.values, "f32").double().numpy(),
                err_msg=name)


# ---- dtype discipline and routing -------------------------------------------

def test_sweep_refuses_mixed_float_dtypes():
    bf = torch.zeros((2, 3), dtype=torch.bfloat16)
    assert _one_dtype(bf, None, bf) == torch.bfloat16
    with pytest.raises(TypeError, match="mix float dtypes"):
        _one_dtype(bf, torch.zeros(3, dtype=torch.float64))
    with pytest.raises(TypeError, match="mix float dtypes"):
        _cn_sweep(bf, torch.zeros((2, 3), dtype=torch.float64), ())


def test_precision_routing():
    """The engine default, the spec override, fusing only within one
    precision, validation on and off, and the bad names."""
    eng = SimEngine(TOP, PA, device="cpu", precision="bf16")
    specs = [QuerySpec(origins=(o,), seed=o, rng="independent",
                       precision=p)
             for o, p in ((0, None), (1, None), (2, "f32"), (3, "f64"))]
    out = eng.run_many(specs, "fd-dynamic")
    assert [r.precision for r in out] == ["bf16", "bf16", "f32", "f64"]
    assert [r.batch_size for r in out] == [2, 2, 1, 1]
    assert "tolerance" in out[0].extras and "tolerance" not in out[3].extras
    f64 = SimEngine(TOP, PA, device="cpu").run(specs[3], "fd-dynamic")
    np.testing.assert_array_equal(out[3].values, f64.values)
    quiet = SimEngine(TOP, PA, device="cpu", precision="f32",
                      validate_precision=False).run(specs[2], "fd-dynamic")
    assert "tolerance" not in quiet.extras
    np.testing.assert_array_equal(quiet.values, out[2].values)
    with pytest.raises(ValueError, match="precision"):
        SimEngine(TOP, PA, device="cpu", precision="f16")
