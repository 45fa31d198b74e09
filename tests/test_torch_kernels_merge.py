"""The port's score-list merge (plain PyTorch version + dispatch) against
the reference package's oracle and its Pallas kernel in interpret mode.

Mirrors tests/test_kernels_merge.py.  Inputs are made with numpy from a
seed and handed to both packages; every comparison is exact
(``assert_array_equal``): the merge is compare/select only.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import jaxcompat
from repro.core.scorelist import empty_scorelist as jax_empty_scorelist
from repro.kernels.merge import merge_pallas
from repro.kernels.merge import merge_ref as jax_merge_ref
import repro_torch.kernels.merge.merge as merge_mod
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


# ---------------------------------------------------------------------------
# numpy model of the CUDA kernel (csrc/merge.cu): its launch plan, the
# tiles' bulk copies, and the rank-and-place step of a tile
# ---------------------------------------------------------------------------

_CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
       / "csrc" / "merge.cu")


def _cu_constants():
    """The kernel's ``constexpr int`` constants, read from its source."""
    return {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", _CU.read_text())}


C = _cu_constants()
_ITEMSIZE = {"f64": 8, "f32": 4, "bf16": 2}


def test_merge_constants_match_source():
    """The wrapper plans with the kernel's own constants."""
    for name in ("THREADS", "MAX_TILE_K", "BULK_K", "STAGE_BYTES",
                 "STAGES", "SMS", "SM_SMEM", "SMEM_RESERVED", "SMEM_MAX",
                 "BULK_BLOCKS", "ROW_BLOCKS", "SM_THREADS",
                 "DIRECT_INFLIGHT", "BULK_MIN_ROWS", "WARP_MIN_ROWS",
                 "ALIGN"):
        assert getattr(merge_mod, name) == C[name], name


def _model_copies(plan, rows, k, size, bases):
    """Every bulk copy the plan's blocks issue, as (base name, address,
    bytes, shared-memory offset or None for a store), and how many times
    the blocks' tiles cover each row."""
    R = plan.rows_per_tile
    n = R * k
    copies, covered = [], np.zeros(rows, np.int64)
    for b in range(plan.grid):
        for i, t in enumerate(range(b, plan.tiles, plan.grid)):
            r0, nr = t * R, min(R, rows - t * R)
            covered[r0:r0 + nr] += 1
            if plan.route != merge_mod.BULK:
                continue
            stage = i % plan.stages * 2 * n * (size + 4)
            for name, width, off in (("va", size, 0), ("ia", 4, n * size),
                                     ("vb", size, n * (size + 4)),
                                     ("ib", 4, n * (2 * size + 4))):
                copies.append((name, bases[name] + r0 * k * width,
                               nr * k * width, stage + off))
            for name, width in (("vo", size), ("io", 4)):
                copies.append((name, bases[name] + r0 * k * width,
                               nr * k * width, None))
    return copies, covered


# The launches the plan sends to the ring: the sweep's k = 32 in f32 and
# bf16 from BULK_MIN_ROWS rows, the only ones where tools/merge_levels.py
# measured it faster than a direct launch on the H100.
_RING = {(32, "f32"), (32, "bf16")}


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("k", [1, 3, 20, 32, 33, 512, 513, 4096])
def test_merge_plan_model(k, dtype, offset):
    """``merge_plan`` held to properties, its inputs a contiguous view
    ``offset`` rows into a larger tensor: the route (row past MAX_TILE_K,
    the ring only for the launches in ``_RING``, direct otherwise);
    tiles that cover every row exactly once; every bulk copy and store
    16-byte aligned in address and size, in shared memory too; the
    ring's stages, output tile, masks and barriers within the block's
    shared memory, the blocks an SM holds within the SM's; every
    element of a tile held by a thread."""
    size = _ITEMSIZE[dtype]
    mib = 1 << 20
    bases = {"va": 1 * mib, "ia": 3 * mib, "vb": 5 * mib, "ib": 7 * mib,
             "vo": 9 * mib, "io": 11 * mib}
    for name in ("va", "vb"):
        bases[name] += offset * k * size
    for name in ("ia", "ib"):
        bases[name] += offset * k * 4
    big = C["BULK_MIN_ROWS"]
    for rows in (1, 15, 17, 33, 70_001, big - 1, big, big + 3):
        plan = merge_mod.merge_plan(rows, k, size, list(bases.values()))
        if k > C["MAX_TILE_K"]:
            want = merge_mod.ROW
        elif (k, dtype) in _RING and rows >= big:
            want = merge_mod.BULK
        else:
            want = merge_mod.DIRECT
        assert plan.route == want, (rows, plan)
        copies, covered = _model_copies(plan, rows, k, size, bases)
        assert (covered == 1).all()
        assert plan.tiles == -(-rows // plan.rows_per_tile)
        assert plan.grid <= plan.tiles
        assert plan.smem <= C["SMEM_MAX"]
        if plan.route == merge_mod.ROW:
            assert plan.rows_per_tile == 1 and plan.smem == 0
            continue
        # every element of a tile is a thread's, and a block holds them
        assert plan.ept * plan.threads >= 2 * k * plan.rows_per_tile
        assert plan.threads <= 1024
        if plan.route == merge_mod.DIRECT:
            assert plan.grid == plan.tiles        # a block a tile
            assert plan.smem <= 2 * k * plan.rows_per_tile * 8
            continue
        R = plan.rows_per_tile
        assert plan.threads == C["THREADS"] and plan.stages == C["STAGES"]
        assert 2 * R <= C["THREADS"]            # one mask byte a thread
        # the ring, the output tile, the masks, an mbarrier a stage
        ring = plan.stages * 2 * R * k * (size + 4)
        assert 2 * R * k * (size + 4) <= C["STAGE_BYTES"]
        assert ring + R * k * (size + 4) + 2 * R + 8 * plan.stages \
            <= plan.smem
        blocks = -(-plan.grid // C["SMS"])
        assert blocks <= C["BULK_BLOCKS"]
        assert blocks * (plan.smem + C["SMEM_RESERVED"]) <= C["SM_SMEM"]
        # the bytes in flight an SM no longer depend on the element size
        assert blocks * ring >= 32 * 1024
        assert copies
        for name, addr, nbytes, dst in copies:
            assert addr % 16 == 0 and nbytes % 16 == 0 and nbytes > 0, name
            assert dst is None or dst % 16 == 0, name


def test_merge_plan_forced_routes_and_refusals():
    """A forced route is planned where it can run and refused where it
    cannot: the ring at any k but 32 or off alignment, direct past
    MAX_TILE_K."""
    plan = merge_mod.merge_plan
    assert plan(10, 32, 8, route=merge_mod.BULK).route == merge_mod.BULK
    assert plan(10**6, 32, 8, route=merge_mod.DIRECT).grid == 125_000
    assert plan(10**6, 20, 8, route=merge_mod.DIRECT).grid == 125_000
    assert plan(2047, 20, 8, route=merge_mod.DIRECT).grid == 342
    # 16 < k <= 32: a warp a row pair from 2,048 rows, else the first
    # design
    for rows, ept in ((1, 1), (2047, 1), (2048, 2), (70_001, 2)):
        for k in (17, 20, 32):
            assert plan(rows, k, 4).ept == ept, (rows, k)
    assert plan(10**6, 16, 8, route=merge_mod.DIRECT).threads == 256
    assert plan(10**6, 33, 8, route=merge_mod.DIRECT).grid == 333_334
    assert plan(10, 32, 8, route=merge_mod.ROW).rows_per_tile == 1
    for args in ((10, 32, 8, [8]), (10**6, 32, 4, [4096, 8]),
                 (10**6, 16, 4), (10**6, 64, 2), (10, 513, 8)):
        with pytest.raises(ValueError):
            plan(*args, route=merge_mod.BULK)
        assert plan(*args).route != merge_mod.BULK
    with pytest.raises(ValueError):
        plan(10, 513, 8, route=merge_mod.DIRECT)
    with pytest.raises(ValueError):
        plan(0, 32, 8)
    # the sweep's widest launch takes the ring in f32 and bf16; in f64 the
    # direct route's own loads keep enough bytes in flight
    for size, route in ((8, merge_mod.DIRECT), (4, merge_mod.BULK),
                        (2, merge_mod.BULK)):
        assert plan(32 * 20968, 32, size).route == route


_NEG_INF_BITS = {"f64": -4503599627370496, "f32": -8388608, "bf16": -128}
_BITS_NP = {"f64": np.int64, "f32": np.int32, "bf16": np.int16}


def _key(bits):
    """Num<T>::key on sign-extended bits (int64): the IEEE total order."""
    b = bits.astype(np.int64)
    return b ^ ((b >> 63) & np.int64(0x7FFF_FFFF_FFFF_FFFF))


def _model_rank_and_place(va, ia, vb, ib, ma, mb, neg_inf):
    """The kernel's rank-and-place step of a tile on bit patterns: mask
    to -inf, key, count by binary lifting over the other row's keys (a
    counts b > x, b counts a >= x; for a power-of-two k without a bounds
    test, as the ring and the warp launch do at k = 32 over warp
    shuffles, else with one, as the warp launch below 32 and the row
    route do), place at j + count when < k.  Every output slot must be
    written exactly once."""
    R, k = va.shape
    xa = np.where(ma[:, None], va, neg_inf)
    xb = np.where(mb[:, None], vb, neg_inf)
    x = np.concatenate([xa, xb], axis=1)
    o = np.concatenate([ia, ib], axis=1)
    keys = _key(x)
    c = np.arange(2 * k)
    a = c < k
    j = np.where(a, c, c - k)
    other = np.where(a[None, :], k, 0)          # column of the other row
    lo = np.zeros((R, 2 * k), np.int64)

    def count(idx):          # does the other row's key at idx count?
        y = np.take_along_axis(keys, other + idx, axis=1)
        return (y > keys) | (~a[None, :] & (y == keys))

    if k & (k - 1) == 0:
        # a power of two: lo + half - 1 < k at every step, then lo itself
        half = k // 2
        while half:
            lo = np.where(count(lo + half - 1), lo + half, lo)
            half >>= 1
        lo = np.where(count(lo), lo + 1, lo)
    else:
        stp = 1 << (k.bit_length() - 1)
        while stp:
            p = lo + stp
            lo = np.where((p <= k) & count(np.minimum(p, k) - 1), p, lo)
            stp >>= 1
    pos = j[None, :] + lo
    out_v = np.zeros((R, k), x.dtype)
    out_i = np.zeros((R, k), np.int32)
    hits = np.zeros((R, k), np.int64)
    for r in range(R):
        keep = pos[r] < k
        out_v[r, pos[r, keep]] = x[r, keep]
        out_i[r, pos[r, keep]] = o[r, keep]
        np.add.at(hits[r], pos[r, keep], 1)
    assert (hits == 1).all()
    return out_v, out_i


def _desc_bits(rng, shape, dtype, specials):
    """Descending lists as bit patterns: lattice values (ties), -inf
    tails, and with ``specials`` signed zeros, infinities and NaNs of
    both signs, sorted in the total order."""
    v = rng.integers(0, 6, shape) / 8.0
    if specials:
        pool = np.array([0., -0., np.inf, -np.inf, np.nan, -np.nan, .5, -.5])
        v = np.where(rng.random(shape) < 0.3, rng.choice(pool, shape), v)
    n_inf = rng.integers(0, shape[-1] + 1, shape[:-1] + (1,))
    v = np.where(np.arange(shape[-1]) >= shape[-1] - n_inf, -np.inf, v)
    if dtype == "f64":
        bits = v.view(np.int64)
    elif dtype == "f32":
        bits = v.astype(np.float32).view(np.int32)
    else:
        bits = (v.astype(np.float32).view(np.uint32) >> 16).astype(
            np.uint16).view(np.int16)
    order = np.argsort(-_key(bits), axis=-1, kind="stable")
    return np.take_along_axis(bits, order, axis=-1)


@pytest.mark.parametrize("specials", [False, True])
@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("k", [1, 3, 12, 16, 32])
def test_merge_rank_model_matches_merge_ref(k, dtype, specials):
    """The kernel's rank-and-place step, modelled in numpy on bits, is
    bit-equal to the reference's oracle (``merge_ref`` of the JAX
    package) and to the port's ``merge_ref`` on ties, -inf tails, +-0,
    NaNs of both signs and row masks."""
    rng = np.random.default_rng(k * 7 + len(dtype) + specials)
    R = 9
    va = _desc_bits(rng, (R, k), dtype, specials)
    vb = _desc_bits(rng, (R, k), dtype, specials)
    ia = rng.integers(0, 500, (R, k)).astype(np.int32)
    ib = rng.integers(500, 999, (R, k)).astype(np.int32)
    jdt = {"f64": np.float64, "f32": np.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f64": torch.float64, "f32": torch.float32,
           "bf16": torch.bfloat16}[dtype]
    for ma, mb in ((np.ones(R, bool), np.ones(R, bool)),
                   (rng.random(R) < 0.6, rng.random(R) < 0.6)):
        v, i = _model_rank_and_place(va, ia, vb, ib, ma, mb,
                                     _NEG_INF_BITS[dtype])
        with jaxcompat.enable_x64():
            jv, ji = jax_merge_ref(jnp.asarray(va.view(jdt)), ia,
                                   jnp.asarray(vb.view(jdt)), ib,
                                   valid_a=ma, valid_b=mb)
            jv, ji = np.asarray(jv), np.asarray(ji)
        assert jv.dtype == np.dtype(jdt)
        np.testing.assert_array_equal(jv.view(_BITS_NP[dtype]), v)
        np.testing.assert_array_equal(ji, i)
        tv, ti = merge_ref(torch.from_numpy(va).view(tdt), torch.from_numpy(ia),
                           torch.from_numpy(vb).view(tdt), torch.from_numpy(ib),
                           valid_a=torch.from_numpy(ma),
                           valid_b=torch.from_numpy(mb))
        np.testing.assert_array_equal(
            tv.view(getattr(torch, _BITS_NP[dtype].__name__)).numpy(), v)
        np.testing.assert_array_equal(ti.numpy(), i)


def _distinct_lists(rng, lead, k, dtype):
    """Two descending lists of one dtype whose values are all distinct
    (so that the bitonic network's tie order cannot differ)."""
    if dtype == "int32":
        pool = rng.permutation(10 * k)[:2 * k * int(np.prod(lead, dtype=int))]
        x = pool.reshape(lead + (2 * k,)).astype(np.int32) - 5 * k
    else:       # distinct f16 values: integers below 2**11
        pool = rng.permutation(2048)[:2 * k]
        x = np.broadcast_to(pool, lead + (2 * k,)).astype(np.float16) / 4
        x = rng.permuted(x, axis=-1)
    a, b = -np.sort(-x[..., :k], axis=-1), -np.sort(-x[..., k:], axis=-1)
    ia = rng.integers(0, 10**6, lead + (k,)).astype(np.int32)
    ib = rng.integers(0, 10**6, lead + (k,)).astype(np.int32)
    return a, ia, b, ib


@pytest.mark.parametrize("dtype", ["float16", "int32"])
@pytest.mark.parametrize("k", [513, 1000])
def test_merge_large_k_and_promoted_values(k, dtype):
    """Lists longer than a tile (the row route on the card) with f16 and
    int32 values, which merge in f32: the port's CPU path equals the
    reference's oracle and its Pallas kernel (interpret mode), and the
    CUDA wrapper computes in the same dtype and plans the row route."""
    rng = np.random.default_rng(k + len(dtype))
    va, ia, vb, ib = _distinct_lists(rng, (2,), k, dtype)
    ma, mb = np.array([True, False]), np.array([True, True])
    v, i = _port(va, ia, vb, ib)
    assert v.dtype == np.float32 and i.dtype == np.int32
    with jaxcompat.enable_x64():
        v2, i2 = jax_merge_ref(va, ia, vb, ib)
        v3, i3 = merge_pallas(va, ia, vb, ib, interpret=True)
        v4, i4 = jax_merge_ref(va, ia, vb, ib, valid_a=ma, valid_b=mb)
    for want_v, want_i in ((v2, i2), (v3, i3)):
        np.testing.assert_array_equal(v, np.asarray(want_v))
        np.testing.assert_array_equal(i, np.asarray(want_i))
    vm, im = _port(va, ia, vb, ib, valid_a=ma, valid_b=mb)
    np.testing.assert_array_equal(vm, np.asarray(v4))
    np.testing.assert_array_equal(im, np.asarray(i4))
    ta, tb = torch.from_numpy(va), torch.from_numpy(vb)
    assert merge_mod.compute_dtype(ta, tb) == torch.float32
    assert merge_mod.merge_plan(2, k, torch.float32).route == merge_mod.ROW


def test_merge_compute_dtype_follows_merge_ref():
    """The CUDA wrapper promotes values as ``merge_ref`` does: f64, f32
    and bf16 keep their type, f16 and integers go to f32; a pair that
    does not come to one type that way is refused, as the wrapper
    refused mixed lists before the promotion."""
    z = torch.zeros((2, 4), dtype=torch.int32)
    for da, db in ((torch.float64, torch.float64), (torch.float32,) * 2,
                   (torch.bfloat16,) * 2, (torch.float16,) * 2,
                   (torch.int32,) * 2, (torch.int64,) * 2,
                   (torch.float16, torch.float32),
                   (torch.int32, torch.float32)):
        a, b = torch.zeros((2, 4), dtype=da), torch.zeros((2, 4), dtype=db)
        assert merge_mod.compute_dtype(a, b) == merge_ref(a, z, b, z)[0].dtype
    for da, db in ((torch.float32, torch.float64),
                   (torch.bfloat16, torch.float16),
                   (torch.bfloat16, torch.float32),
                   (torch.int32, torch.float64)):
        a, b = torch.zeros((2, 4), dtype=da), torch.zeros((2, 4), dtype=db)
        with pytest.raises(ValueError):
            merge_mod.compute_dtype(a, b)


def test_merge_promote_keeps_the_total_order():
    """f16 lists cast to f32 before the kernel: a cast that turns a NaN
    into another (the card's cast makes every NaN the one +NaN) can
    leave a list out of the total order, so the wrapper sorts such a
    list again, stably.  The cast lists are sorted, equal keys keep
    their order, and the kernel's rank-and-place step on them equals
    ``merge_ref`` on them.  (The host's own cast is not even the same
    for every element of a tensor, so the card's check, ``chip_smoke.py``
    phase 2, holds the wrapper to ``merge_ref`` on the f16 lists.)"""
    # +NaN with a payload, 1.0, +0.0, -0.0 (twice), -inf, -NaN
    a16 = np.array([[0x7E01, 0x3C00, 0, -32768, -32768, -1024, -512]],
                   np.int16)
    b16 = np.array([[0x7C00, 0x3C00, 0x3800, 0, -32768, -512, -511]],
                   np.int16)
    ia = np.arange(7, dtype=np.int32)[None]
    ib = ia + 100
    ta, tb = (torch.from_numpy(x).view(torch.float16) for x in (a16, b16))
    pa, pia, _ = merge_mod._promote(ta, torch.from_numpy(ia), None,
                                    torch.float32)
    pb, pib, _ = merge_mod._promote(tb, torch.from_numpy(ib), None,
                                    torch.float32)
    assert pa.dtype == pb.dtype == torch.float32
    for pv, pi in ((pa, pia), (pb, pib)):
        key = _key(pv.view(torch.int32).numpy())
        assert (key[:, :-1] >= key[:, 1:]).all()
        tie = key[:, :-1] == key[:, 1:]
        assert (pi.numpy()[:, :-1][tie] < pi.numpy()[:, 1:][tie]).all()
    ones = np.ones(1, bool)
    v, i = _model_rank_and_place(pa.view(torch.int32).numpy(), pia.numpy(),
                                 pb.view(torch.int32).numpy(), pib.numpy(),
                                 ones, ones, _NEG_INF_BITS["f32"])
    rv, ri = merge_ref(pa, pia, pb, pib)
    np.testing.assert_array_equal(v, rv.view(torch.int32).numpy())
    np.testing.assert_array_equal(i, ri.numpy())
    # an integer list keeps its order when cast
    ti = torch.tensor([[9, 7, 7, -3]], dtype=torch.int32)
    m = torch.tensor([False])
    pv, _, pm = merge_mod._promote(ti, torch.zeros_like(ti), m, torch.float32)
    np.testing.assert_array_equal(pv.numpy(), [[9., 7., 7., -3.]])
    assert pm is m
    # a masked f16 list is masked before it is sorted again: its owners
    # keep their order, as merge_ref's masked list does
    pv, pi, pm = merge_mod._promote(ta, torch.from_numpy(ia), m,
                                    torch.float32)
    assert pm is None and bool(torch.isneginf(pv).all())
    np.testing.assert_array_equal(pi.numpy(), ia)
