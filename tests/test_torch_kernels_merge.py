"""The port's score-list merge (plain PyTorch version + dispatch) against
the reference package's oracle and its Pallas kernel in interpret mode.

Mirrors tests/test_kernels_merge.py.  Inputs are made with numpy from a
seed and handed to both packages; every comparison is exact
(``assert_array_equal``): the merge is compare/select only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import jaxcompat
from repro.core.scorelist import empty_scorelist as jax_empty_scorelist
from repro.kernels.merge import merge_pallas
from repro.kernels.merge import merge_ref as jax_merge_ref
from repro_torch.core.scorelist import empty_scorelist
from repro_torch.kernels.merge import merge_cuda, merge_ref, merge_scorelists


def _mk_list(rng, shape, k, dtype=np.float64):
    """A descending top-k list of 4k normals (tie-free), as numpy."""
    x = rng.standard_normal(shape + (4 * k,)).astype(dtype)
    pos = np.argsort(-x, axis=-1, kind="stable")[..., :k]
    return (np.take_along_axis(x, pos, axis=-1),
            pos.astype(np.int32) + 100)


def _port(v, i, *rest, **masks):
    """The port's merge on CPU tensors, returned as numpy."""
    tv = merge_scorelists(torch.from_numpy(v), torch.from_numpy(i),
                          *(torch.from_numpy(a) for a in rest),
                          **{key: None if m is None else torch.from_numpy(m)
                             for key, m in masks.items()})
    return tv[0].numpy(), tv[1].numpy()


@pytest.mark.parametrize("k", [1, 4, 7, 16, 20, 64])
@pytest.mark.parametrize("lead", [(), (3,), (2, 5)])
def test_merge_matches_reference_and_pallas(k, lead):
    rng = np.random.default_rng(k * 10 + len(lead))
    va, ia = _mk_list(rng, lead, k)
    vb, ib = _mk_list(rng, lead, k)
    v, i = _port(va, ia, vb, ib)
    assert v.dtype == np.float64 and i.dtype == np.int32
    with jaxcompat.enable_x64():
        v2, i2 = jax_merge_ref(va, ia, vb, ib)
        np.testing.assert_array_equal(v, np.asarray(v2))
        np.testing.assert_array_equal(i, np.asarray(i2))
        if lead == (2, 5):       # the interpreter traces once per k
            v3, i3 = merge_pallas(va, ia, vb, ib, interpret=True)
            np.testing.assert_array_equal(v, np.asarray(v3))
            np.testing.assert_array_equal(i, np.asarray(i3))


def test_merge_identity():
    """The all-(-inf) list is the identity element of the merge."""
    va, ia = _mk_list(np.random.default_rng(1), (), 8)
    ev = np.full(8, -np.inf)
    ei = np.full(8, -1, np.int32)
    for a, b in (((va, ia), (ev, ei)), ((ev, ei), (va, ia))):
        v, i = _port(*a, *b)
        np.testing.assert_array_equal(v, va)
        np.testing.assert_array_equal(i, ia)
    # the port's empty score-list is that list, as the reference's is
    tv, ti = empty_scorelist((), 8)
    rv, ri = jax_empty_scorelist((), 8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    v, i = merge_scorelists(torch.from_numpy(va.astype(np.float32)),
                            torch.from_numpy(ia), tv, ti)
    np.testing.assert_array_equal(v.numpy(), va.astype(np.float32))
    np.testing.assert_array_equal(i.numpy(), ia)


@settings(max_examples=12, deadline=None)
@given(k=st.integers(1, 32), seed=st.integers(0, 999))
def test_merge_commutative_and_topk_of_union(k, seed):
    rng = np.random.default_rng(seed)
    va, ia = _mk_list(rng, (), k)
    vb, ib = _mk_list(rng, (), k)
    v1, _ = _port(va, ia, vb, ib)
    v2, _ = _port(vb, ib, va, ia)
    np.testing.assert_array_equal(v1, v2)
    union = np.concatenate([va, vb])
    np.testing.assert_array_equal(v1, np.sort(union)[::-1][:k])


@settings(max_examples=8, deadline=None)
@given(k=st.integers(1, 16), seed=st.integers(0, 99))
def test_merge_associative(k, seed):
    rng = np.random.default_rng(seed)
    (va, ia), (vb, ib), (vc, ic) = (_mk_list(rng, (), k) for _ in range(3))
    l1 = _port(*_port(va, ia, vb, ib), vc, ic)
    l2 = _port(va, ia, *_port(vb, ib, vc, ic))
    np.testing.assert_array_equal(l1[0], l2[0])
    np.testing.assert_array_equal(l1[1], l2[1])


@pytest.mark.parametrize("k", [4, 8, 20])
def test_merge_valid_masks_match_premasked(k):
    """Row masks == pre-masking the values to -inf, == the reference's
    masked oracle and Pallas kernel; an invalid list is absorbed like
    the empty list."""
    rng = np.random.default_rng(7)
    lead = (3, 5)
    va, ia = _mk_list(rng, lead, k)
    vb, ib = _mk_list(rng, lead, k)
    ma = rng.random(lead) < 0.5
    mb = rng.random(lead) < 0.5
    v1, i1 = _port(va, ia, vb, ib, valid_a=ma, valid_b=mb)
    v2, i2 = _port(np.where(ma[..., None], va, -np.inf), ia,
                   np.where(mb[..., None], vb, -np.inf), ib)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(i1, i2)
    with jaxcompat.enable_x64():
        v3, i3 = jax_merge_ref(va, ia, vb, ib, valid_a=ma, valid_b=mb)
        v4, i4 = merge_pallas(va, ia, vb, ib, valid_a=ma, valid_b=mb)
    np.testing.assert_array_equal(v1, np.asarray(v3))
    np.testing.assert_array_equal(i1, np.asarray(i3))
    # the bitonic network orders ties (rows where both lists are
    # masked to -inf) its own way: its owners count where values are real
    np.testing.assert_array_equal(v1, np.asarray(v4))
    real = np.isfinite(v1)
    np.testing.assert_array_equal(i1[real], np.asarray(i4)[real])
    ones = np.ones(lead, bool)
    v6, _ = _port(va, ia, vb, ib, valid_b=ones)
    v0, _ = _port(va, ia, vb, ib)
    np.testing.assert_array_equal(v6, v0)
    v5, i5 = _port(va, ia, vb, ib, valid_b=~ones)
    np.testing.assert_array_equal(v5, va)
    np.testing.assert_array_equal(i5, ia)


def test_merge_dtype_passthrough():
    """f64, f32 and bf16 lists merge in their own dtype; f64 equals the
    exact top-k of the union."""
    rng = np.random.default_rng(0)
    va = np.sort(rng.random((4, 8)))[:, ::-1].copy()
    vb = np.sort(rng.random((4, 8)))[:, ::-1].copy()
    ia = rng.integers(0, 99, (4, 8)).astype(np.int32)
    ib = rng.integers(0, 99, (4, 8)).astype(np.int32)
    v, _ = _port(va, ia, vb, ib)
    assert v.dtype == np.float64
    both = np.concatenate([va, vb], axis=1)
    np.testing.assert_array_equal(v, np.sort(both, axis=1)[:, ::-1][:, :8])
    for dt in (torch.float32, torch.bfloat16):
        tv, ti = merge_ref(torch.from_numpy(va).to(dt), torch.from_numpy(ia),
                           torch.from_numpy(vb).to(dt), torch.from_numpy(ib))
        assert tv.dtype == dt and ti.dtype == torch.int32


def test_merge_ties_follow_merge_ref():
    """Tied scores: list ``a`` first, then the lower position — the
    reference oracle's rule, owners included (the bitonic network of the
    reference's CPU sweep duplicates owners here)."""
    va = np.array([.9, .5, .5, .1], np.float32)
    vb = np.array([.9, .5, .2, .1], np.float32)
    ia = np.array([1, 2, 3, 4], np.int32)
    ib = np.array([11, 12, 13, 14], np.int32)
    v, i = _port(va, ia, vb, ib)
    np.testing.assert_array_equal(i, [1, 11, 2, 3])
    np.testing.assert_array_equal(v, np.array([.9, .9, .5, .5], np.float32))
    # many ties, -inf tails, both dtypes: equal to the reference oracle
    rng = np.random.default_rng(5)
    for dt in (np.float64, np.float32):
        lat = np.sort(rng.integers(0, 6, (6, 16)), axis=1)[:, ::-1] / 8.0
        lbt = np.sort(rng.integers(0, 6, (6, 16)), axis=1)[:, ::-1] / 8.0
        lat[:, 12:] = -np.inf
        a, b = lat.astype(dt), lbt.astype(dt)
        oa = rng.integers(0, 500, (6, 16)).astype(np.int32)
        ob = rng.integers(0, 500, (6, 16)).astype(np.int32)
        v, i = _port(a, oa, b, ob)
        with jaxcompat.enable_x64():
            v2, i2 = jax_merge_ref(jnp.asarray(a), oa, jnp.asarray(b), ob)
        np.testing.assert_array_equal(v, np.asarray(v2))
        np.testing.assert_array_equal(i, np.asarray(i2))


def test_merge_routes_by_device_without_fallback():
    """A CPU tensor takes the plain version; a tensor on any other
    non-CUDA device raises; the CUDA wrapper refuses CPU tensors."""
    v = torch.zeros(2, 4, dtype=torch.float64)
    i = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="no path"):
        merge_scorelists(v.to("meta"), i.to("meta"), v.to("meta"),
                         i.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        merge_cuda(v, i, v, i)


def _total_order_desc(x):
    """``x`` (numpy f64/f32) sorted descending in the IEEE total order
    along the last axis (+NaN first, +0.0 above -0.0, -NaN last)."""
    ib = np.int64 if x.dtype == np.float64 else np.int32
    b = x.view(ib)
    key = b ^ ((b >> (8 * x.itemsize - 1)) & np.iinfo(ib).max)
    return np.take_along_axis(x, np.argsort(-key, axis=-1, kind="stable"),
                              axis=-1)


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_merge_total_order_matches_reference(dtype):
    """±0.0, ±inf and ±NaN in both lists: the reference orders by the
    IEEE total order (``lax.top_k``), so +0.0 beats -0.0 whichever list
    holds it, and NaNs sit at the ends.  Exact on values (bits) and
    owners; the fault this guards against returned ``[1, .5, -0.]`` /
    ``[1, 11, 2]`` for the first case below."""
    va = np.array([1, -0., -1]), np.array([1, 2, 3], np.int32)
    vb = np.array([.5, 0., -2]), np.array([11, 12, 13], np.int32)
    rng = np.random.default_rng(4)
    pool = np.array([0., -0., np.inf, -np.inf, np.nan, -np.nan, 1., -1.,
                     .5, .5, -.5])
    la = _total_order_desc(rng.choice(pool, (6, 12)))
    lb = _total_order_desc(rng.choice(pool, (6, 12)))
    oa = rng.integers(0, 500, (6, 12)).astype(np.int32)
    ob = rng.integers(500, 999, (6, 12)).astype(np.int32)
    for (a, ia), (b, ib) in (((va[0], va[1]), (vb[0], vb[1])),
                             ((la, oa), (lb, ob)), ((lb, ob), (la, oa))):
        if dtype == "f64":
            ja, jb = a, b
            ta, tb = torch.from_numpy(a), torch.from_numpy(b)
            bits = (np.int64, torch.int64)
        elif dtype == "f32":
            ja, jb = a.astype(np.float32), b.astype(np.float32)
            ta, tb = torch.from_numpy(ja), torch.from_numpy(jb)
            bits = (np.int32, torch.int32)
        else:       # the same bf16 bits in both: the upper half of f32
            ua = (a.astype(np.float32).view(np.uint32) >> 16)
            ub = (b.astype(np.float32).view(np.uint32) >> 16)
            ja = ua.astype(np.uint16).view(jnp.bfloat16)
            jb = ub.astype(np.uint16).view(jnp.bfloat16)
            ta = torch.from_numpy(ua.astype(np.int16)).view(torch.bfloat16)
            tb = torch.from_numpy(ub.astype(np.int16)).view(torch.bfloat16)
            bits = (np.int16, torch.int16)
        v, i = merge_scorelists(ta, torch.from_numpy(ia), tb,
                                torch.from_numpy(ib))
        with jaxcompat.enable_x64():
            v2, i2 = jax_merge_ref(jnp.asarray(ja), ia, jnp.asarray(jb), ib)
            v2, i2 = np.asarray(v2), np.asarray(i2)
        assert v2.dtype == ja.dtype
        np.testing.assert_array_equal(v.view(bits[1]).numpy(),
                                      v2.view(bits[0]))
        np.testing.assert_array_equal(i.numpy(), i2)
    np.testing.assert_array_equal(
        merge_ref(torch.from_numpy(va[0]), torch.from_numpy(va[1]),
                  torch.from_numpy(vb[0]), torch.from_numpy(vb[1]))[1],
        [1, 11, 12])
