"""The port's local top-k (plain PyTorch version + dispatch) against the
reference package's oracle and its Pallas kernel in interpret mode.

Mirrors tests/test_kernels_topk.py.  Inputs are made with numpy from a
seed, cast to the working dtype by each package (the cast bits are
asserted equal first) and handed to both; every comparison is exact:
the top-k compares and selects, it never computes a new value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.topk import topk_pallas
from repro.kernels.topk import topk_ref as jax_topk_ref
from repro_torch.kernels.topk import local_topk, topk_cuda, topk_ref

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16),
           "f16": (jnp.float16, torch.float16)}


def _both(x32, name):
    """``x32`` (numpy f32) cast by each package to dtype ``name``; the
    two casts are asserted bit-equal."""
    jdt, tdt = _DTYPES[name]
    xj = jnp.asarray(x32).astype(jdt)
    xt = torch.from_numpy(x32).to(tdt)
    bits = np.int32 if name == "f32" else np.int16
    tbits = torch.int32 if name == "f32" else torch.int16
    np.testing.assert_array_equal(np.asarray(xj).view(bits),
                                  xt.view(tbits).numpy())
    return xj, xt


def _exact(x32, name):
    """``x32`` (numpy f32, every value exact in dtype ``name``) as the
    same bits in both packages, NaN signs included (the two packages'
    casts of a NaN to bf16 differ, so nothing is cast here: bf16 takes
    the upper 16 bits, f16 numpy's cast)."""
    jdt, tdt = _DTYPES[name]
    if name == "f32":
        arr = x32
    elif name == "f16":
        arr = x32.astype(np.float16)
    else:
        arr = (x32.view(np.uint32) >> 16).astype(np.uint16).view(jdt)
    bits = arr.view(np.int32 if name == "f32" else np.int16)
    return jnp.asarray(arr), torch.from_numpy(bits.copy()).view(tdt)


def _bits(v):
    """f32 values as their int32 bits (NaNs and signed zeros compare)."""
    return np.ascontiguousarray(np.asarray(v, np.float32)).view(np.int32)


def _assert_same(port, ref):
    np.testing.assert_array_equal(_bits(port[0].numpy()), _bits(ref[0]))
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]))
    assert port[0].dtype == torch.float32 and port[1].dtype == torch.int32


@pytest.mark.parametrize("shape", [(128,), (1, 1000), (3, 777),
                                   (2, 4, 4096)])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("k", [1, 8, 20])
def test_topk_matches_reference_and_pallas(shape, dtype, k):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1] + k)
    xj, xt = _both(rng.standard_normal(shape).astype(np.float32), dtype)
    ref = jax_topk_ref(xj, k)
    _assert_same(topk_ref(xt, k), ref)
    _assert_same(local_topk(xt, k), ref)
    pv, pi = topk_pallas(xj, k, tile_n=1024)
    _assert_same(topk_ref(xt, k), (pv, pi))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
def test_topk_total_order_specials(dtype):
    """±0.0, ±inf, ±NaN and ties: the reference's total order, bit for
    bit (+0.0 above -0.0, +NaN first, -NaN last)."""
    rng = np.random.default_rng(11)
    pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0,
                     -1.0, 0.5, 0.5, -0.5, 2.0], np.float32)
    x32 = rng.choice(pool, size=(5, 300))
    x32[0] = -np.inf
    x32[1, :7] = np.array([-0.0, 0.0, -0.0, np.nan, -np.nan, 0.0, -0.0],
                          np.float32)
    xj, xt = _exact(x32, dtype)
    assert xj.dtype == _DTYPES[dtype][0]
    for k in (1, 7, 40, 300):
        _assert_same(topk_ref(xt, k), jax_topk_ref(xj, k))


def test_topk_neg_inf_slots_keep_their_index():
    """A -inf slot keeps its real index, as in ``topk_ref``; the Pallas
    kernel reports -1 there instead (its running list starts at
    (-inf, -1) and a -inf element never beats it)."""
    x = np.array([1, -np.inf, .5, -np.inf, -np.inf, 3, 2, .5], np.float32)
    v, i = topk_ref(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(i.numpy(), [5, 6, 0, 2, 7, 1])
    np.testing.assert_array_equal(i.numpy(),
                                  np.asarray(jax_topk_ref(x, 6)[1]))
    np.testing.assert_array_equal(
        np.asarray(topk_pallas(jnp.asarray(x), 6, tile_n=128)[1]),
        [5, 6, 0, 2, 7, -1])
    assert v[-1] == float("-inf")


def test_topk_ties_prefer_lowest_index():
    x = torch.zeros(64)
    x[[5, 17]] = 1.0
    _, i = local_topk(x, 3)
    np.testing.assert_array_equal(i.numpy(), [5, 17, 0])
    rng = np.random.default_rng(3)
    lat = (rng.integers(0, 5, (4, 999)) / 4.0).astype(np.float32)
    for k in (1, 20, 200):
        _assert_same(topk_ref(torch.from_numpy(lat), k),
                     jax_topk_ref(lat, k))


def test_topk_index_offset():
    x = np.random.default_rng(2).standard_normal(512).astype(np.float32)
    port = topk_ref(torch.from_numpy(x), 4, index_offset=1000)
    _assert_same(port, jax_topk_ref(x, 4, index_offset=1000))
    assert int(port[1].min()) >= 1000
    _assert_same(local_topk(torch.from_numpy(x), 4, index_offset=1000),
                 jax_topk_ref(x, 4, index_offset=1000))


@settings(max_examples=30, deadline=None)
@given(n=st.integers(1, 600), k=st.integers(1, 16), seed=st.integers(0, 99))
def test_topk_property(n, k, seed):
    k = min(k, n)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x[rng.random(n) < 0.2] = np.round(x[0], 1)        # some ties
    v, i = topk_ref(torch.from_numpy(x), k)
    _assert_same((v, i), jax_topk_ref(x, k))
    v, i = v.numpy(), i.numpy()
    assert np.all(np.diff(v) <= 0)
    np.testing.assert_array_equal(x[i], v)
    np.testing.assert_array_equal(np.sort(x)[::-1][:k], v)


def test_topk_routes_by_device_without_fallback():
    """A CPU tensor takes the plain version; a tensor on any other
    non-CUDA device raises; the CUDA wrapper refuses CPU tensors; k
    above n raises on the plain path too."""
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="no path"):
        local_topk(x.to("meta"), 3)
    with pytest.raises(ValueError, match="CUDA"):
        topk_cuda(x, 3)
    with pytest.raises(ValueError, match="k=17"):
        local_topk(x, 17)
    v, i = local_topk(x.to(torch.float64), 2)
    assert v.dtype == torch.float32 and i.dtype == torch.int32


# ---------------------------------------------------------------------------
# A numpy model of the CUDA kernel's selection (csrc/topk.cu), which
# cannot run here: the same tiles (the wrapper's plan), the same digits
# of the total-order key (the source's first-digit width, then bytes),
# the same three ways through a tile, the same winners and pass 2; held
# to topk_ref, lax.top_k and topk_pallas.
# ---------------------------------------------------------------------------

import re  # noqa: E402
from pathlib import Path  # noqa: E402

import repro_torch.kernels.topk.topk as _wrapper  # noqa: E402
from repro_torch.kernels.topk.ref import to_f32  # noqa: E402
from repro_torch.kernels.topk.topk import MAX_K, TILE, plan  # noqa: E402

_SRC = (Path(_wrapper.__file__).resolve().parents[1] / "csrc"
        / "topk.cu").read_text()
_CONST = {name: int(v) for name, v in
          re.findall(r"constexpr int (\w+) = (\d+);", _SRC)}
FIRST_BITS, CAND = _CONST["FIRST_BITS"], _CONST["CAND"]
THREADS = _CONST["THREADS"]


def _np_keys(x32):
    """Total-order keys of f32 scores, ordering as unsigned (key_of)."""
    b = np.ascontiguousarray(x32, np.float32).view(np.int32)
    b = b ^ ((b >> 31) & 0x7FFFFFFF)
    return b.view(np.uint32) ^ np.uint32(0x80000000)


def _np_values(keys):
    """The inverse of ``_np_keys`` (value_of)."""
    b = (keys.astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
    return (b ^ ((b >> 31) & 0x7FFFFFFF)).view(np.float32)


def _narrow(keys, lo, hi, need, shift, bits):
    """pick_bin: among the keys in [lo, hi], the bin of the ``bits``-bit
    digit at ``shift`` that holds the need-th largest.  Returns the new
    (lo, hi, need, keys in the bin)."""
    u = keys.dtype.type
    inbin = keys[(keys >= u(lo)) & (keys <= u(hi))]
    h = np.bincount(((inbin >> u(shift)) & u((1 << bits) - 1))
                    .astype(np.int64), minlength=1 << bits)
    above = np.cumsum(h[::-1])[::-1] - h          # keys in higher bins
    b = int(np.flatnonzero((above < need) & (above + h >= need))[0])
    lo |= b << shift
    return lo, lo | ((1 << shift) - 1), need - int(above[b]), int(h[b])


def _refine(keys, lo, hi, need, cnt, shift):
    """refine: one byte at a time from ``shift`` down (the last digit
    clamped to bit 0) until the bin holds exactly the keys wanted."""
    while cnt != need:
        lo, hi, need, cnt = _narrow(keys, lo, hi, need, shift, 8)
        if shift == 0:
            break
        shift = max(shift - 8, 0)
    return lo, hi, need, cnt


def _winners(keys, lo, hi, need, cnt):
    """collect: every key above the bin, then the bin's keys: all of
    them, or the need lowest-indexed equal keys."""
    above = np.flatnonzero(keys > hi)
    if cnt == need:
        return np.concatenate([above, np.flatnonzero((keys >= lo)
                                                     & (keys <= hi))])
    assert lo == hi                       # only the last digit leaves ties
    return np.concatenate([above, np.flatnonzero(keys == lo)[:need]])


def _words(keys, local):
    return ((keys.astype(np.uint64) << np.uint64(32))
            | (0xFFFFFFFF - local).astype(np.uint64))


def _tile_words(keys, base, k, paths):
    """Pass 1 of one tile: its min(k, count) winners as words."""
    kt = min(k, len(keys))
    sel = (0, 2 ** 32 - 1, kt, len(keys))
    if kt < len(keys):
        sel = _narrow(keys, *sel[:3], 32 - FIRST_BITS, FIRST_BITS)
    lo, hi, need, cnt = sel
    local = base + np.arange(len(keys))
    if cnt == need:                       # the first bin is all wanted
        paths.add("all")
        return _words(keys, local)[_winners(keys, *sel)]
    if cnt <= CAND:                       # gather the bin as words
        inbin = (keys >= lo) & (keys <= hi)
        w = _words(keys[inbin], local[inbin])
        if cnt <= THREADS:                # by rank, one word a thread
            paths.add("bin words by rank")
            rank = (w[None, :] > w[:, None]).sum(axis=1)
            won = w[rank < need]
        else:
            paths.add("bin words by digits")
            wsel = _refine(w, lo << 32, (hi << 32) | 0xFFFFFFFF, need, cnt,
                           64 - FIRST_BITS - 8)
            assert wsel[2] == wsel[3]     # distinct words: no tie
            won = w[_winners(w, *wsel)]
        return np.concatenate([_words(keys[keys > hi], local[keys > hi]),
                               won])
    paths.add("whole tile")
    sel = _refine(keys, lo, hi, need, cnt, 32 - FIRST_BITS - 8)
    return _words(keys, local)[_winners(keys, *sel)]


def _model_topk(x32, k, index_offset=0, paths=None):
    """Top-k of each row of ``x32`` (f32) as the kernel computes it;
    ``paths`` collects the ways the tiles went."""
    paths = set() if paths is None else paths
    rows, n = x32.shape
    route, tiles, words = plan(n, k)
    assert route == "tiles"
    vals = np.empty((rows, k), np.float32)
    idx = np.empty((rows, k), np.int64)
    for r in range(rows):
        cand = []
        for t in range(tiles):                   # pass 1, one block a tile
            w = _tile_words(_np_keys(x32[r, t * TILE:(t + 1) * TILE]),
                            t * TILE, k, paths)
            assert len(w) == min(k, n - t * TILE)
            cand.append(np.concatenate([w, np.zeros(k - len(w), np.uint64)]))
        cand = np.concatenate(cand)
        if tiles > 1:                            # pass 2 over the words
            assert len(cand) == words
            sel = _refine(cand, 0, 2 ** 64 - 1, k, len(cand), 56)
            assert sel[2] == sel[3]              # distinct words: no tie
            cand = cand[_winners(cand, *sel)]
        w = np.sort(cand)[::-1]
        assert len(w) == k and w[-1] != 0        # no empty slot wins
        vals[r] = _np_values(w >> np.uint64(32))
        idx[r] = (0xFFFFFFFF - (w & np.uint64(0xFFFFFFFF))).astype(np.int64)
    return vals, (idx + index_offset).astype(np.int32)


def _adversarial(case, k, seed):
    """Scores (rows, n) as f32, every value exact in bf16 and f16."""
    rng = np.random.default_rng(seed)
    if case == "ties_over_tiles":          # > k tied at the k-th key
        return (rng.integers(0, 4, (3, 3 * TILE + 5)) / 4).astype(np.float32)
    if case == "few_winners_at_seams":     # 1.0 at the tile seams only
        x = np.zeros((2, 3 * TILE + 5), np.float32)
        x[:, 1::2] = -0.0
        x[0, [TILE - 1, TILE, 2 * TILE - 1, 2 * TILE, 3 * TILE + 4]] = 1.0
        x[1, -40:] = 1.0
        return x
    if case == "one_value":
        return np.full((2, TILE + 1), 0.5, np.float32)
    if case.startswith("n_tile"):          # n = TILE - 1, TILE, TILE + 1
        n = TILE + {"n_tile_minus_1": -1, "n_tile": 0,
                    "n_tile_plus_1": 1}[case]
        return ((rng.integers(0, 17, (2, n)) - 8) / 8).astype(np.float32)
    if case == "n_eq_k":
        return ((rng.integers(0, 5, (3, k)) - 2) / 2).astype(np.float32)
    if case == "specials_at_threshold":    # the k-th key is a special
        pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0],
                        np.float32)
        return rng.choice(pool, size=(3, 2 * TILE + 3))
    if case == "normal":                   # the device path's scores
        return rng.standard_normal((2, 2 * TILE + 100)).astype(np.float32)
    if case == "all_neg_inf":
        return np.full((2, TILE + 7), -np.inf, np.float32)
    raise ValueError(case)


_CASES = ("ties_over_tiles", "few_winners_at_seams", "one_value",
          "n_tile_minus_1", "n_tile", "n_tile_plus_1", "n_eq_k",
          "specials_at_threshold", "all_neg_inf", "normal")


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("k", [1, 20, MAX_K])
def test_topk_kernel_model_matches_reference(case, dtype, k):
    """The kernel's selection, modelled step by step, equals the port's
    plain version and lax.top_k bit for bit on the inputs that break
    selections by counting."""
    x32 = _adversarial(case, k, seed=len(case) + k)
    xj, xt = _exact(x32, dtype)
    wide = to_f32(xt).numpy()
    ref = jax_topk_ref(xj, k, index_offset=5)
    port = topk_ref(xt, k, index_offset=5)
    _assert_same(port, ref)
    got = _model_topk(wide, k, index_offset=5)
    _assert_same((torch.from_numpy(got[0]), torch.from_numpy(got[1])), ref)


@pytest.mark.parametrize("case", ["ties_over_tiles", "few_winners_at_seams",
                                  "one_value", "n_tile_plus_1"])
def test_topk_kernel_model_matches_pallas(case):
    """The model against the TPU kernel in interpret mode, on inputs
    whose top-k holds no -inf (where topk_pallas reports index -1) and
    no -0.0 (topk_pallas compares floats, so -0.0 ties with +0.0)."""
    x32 = _adversarial(case, 20, seed=3)
    x32 = np.where(x32 == 0, np.float32(0.0), x32)
    got = _model_topk(x32, 20)
    pv, pi = topk_pallas(jnp.asarray(x32), 20, tile_n=8192)
    _assert_same((torch.from_numpy(got[0]), torch.from_numpy(got[1])),
                 (pv, pi))


def test_topk_plan_matches_launcher():
    """The wrapper's tiles and scratch are what the launcher of
    csrc/topk.cu accepts (ceil(n / TILE) tiles, tiles * k words a row
    when a row has several), at the device path's three shapes, and its
    constants and argument list match the source; k above MAX_K is the
    select route's (csrc/topk_select.cu)."""
    assert _CONST["TILE"] == TILE and _CONST["MAX_K"] == MAX_K
    assert "tiles != (n + TILE - 1) / TILE" in _SRC
    assert "k < 1 || k > MAX_K" in _SRC
    params = re.search(r"extern \"C\" int NAME\(([^)]*)\)", _SRC).group(1)
    assert len(params.split(",")) == len(_wrapper._ARGTYPES)
    # local execution, CN and CN* of the device path (B = 32, P = 64,
    # N = 64 x 20,000, k = 20)
    assert plan(20_000, 20) == ("tiles", 1, 0)
    assert plan(1_280_000, 20) == ("tiles", 63, 63 * 20)
    assert plan(1_280, 20) == ("tiles", 1, 0)
    assert plan(TILE, 256) == ("tiles", 1, 0)
    assert plan(TILE + 1, 256) == ("tiles", 2, 512)
    assert plan(2 ** 31, 256) == ("tiles", -(-2 ** 31 // TILE),
                                  -(-2 ** 31 // TILE) * 256)
    assert plan(TILE + 1, 257).route == "resident"


def test_topk_kernel_model_takes_every_path():
    """The inputs above drive the model through every way a tile can
    go: the first bin wholly wanted, the bin gathered as words and
    ranked (the device path's normal scores) or narrowed by digits, and
    the whole tile (heavy ties)."""
    paths = {}
    for case in _CASES:
        seen = set()
        _model_topk(_adversarial(case, 20, seed=1), 20, paths=seen)
        paths[case] = seen
    assert "bin words by rank" in paths["normal"]
    assert "bin words by digits" in paths["n_tile"]   # ~1200 equal keys
    assert paths["n_eq_k"] == {"all"}
    assert "whole tile" in paths["one_value"]
    assert "whole tile" in paths["ties_over_tiles"]


# ---------------------------------------------------------------------------
# The select routes (k > MAX_K, csrc/topk_select.cu), modelled step by
# step in numpy with the source's constants: the resident route (the
# first digit counted as the row arrives; the bin narrowed to the k-th
# key T by bytes, over its keys gathered in the room or over the row, a
# bin of one key value ending at once; the winners, every key above T
# and the first need_eq keys equal to T, compacted in row order by
# (round, warp) cells of 16-byte vectors, the row's alignment shift
# included; a bitonic sort up to SORT_SLOTS, else the LSD radix sort)
# and the long route (a row's first digit summed by cluster slices,
# each tile's candidates in row order in its own region, the final
# select and sort over the gathered candidates, in shared memory or in
# scratch); held to topk_ref and lax.top_k.
# ---------------------------------------------------------------------------

_SEL_SRC = (Path(_wrapper.__file__).resolve().parents[1] / "csrc"
            / "topk_select.cu").read_text()
_SEL = {name: int(v) for name, v in
        re.findall(r"constexpr int (\w+) = (\d+);", _SEL_SRC)}
_SEL.update({name: 1 << _SEL[v] for name, v in
             re.findall(r"constexpr int (\w+) = 1 << (\w+);", _SEL_SRC)})
_SEL_WARPS = _SEL["THREADS"] // 32


def _sel_pick(h, need):
    """pick_bin over a histogram (bins ascending): the bin holding the
    need-th largest key, the keys still wanted from it, its count and
    the keys above it."""
    above = np.cumsum(h[::-1])[::-1] - h
    b = int(np.flatnonzero((above < need) & (above + h >= need))[0])
    return b, int(need - above[b]), int(h[b]), int(above[b])


def _sel_refine(src, lo, hi, need, cnt, shift, paths):
    """refine: 8-bit digits of the keys of ``src`` in [lo, hi] from
    ``shift`` down (the last clamped to bit 0) until the bin holds the
    keys wanted or one key; a pass whose bin keys are one value ends
    there."""
    while cnt != need and lo != hi:
        inbin = src[(src >= lo) & (src <= hi)].astype(np.int64)
        h = np.bincount((inbin >> shift) & (_SEL["BINS"] - 1),
                        minlength=_SEL["BINS"])
        b, need, cnt, _ = _sel_pick(h, need)
        lo |= b << shift
        hi = lo | ((1 << shift) - 1)
        if inbin.min() == inbin.max():
            paths.add("one key")
            lo = hi = int(inbin.min())
            break
        if shift == 0:
            break
        shift = max(shift - _SEL["BITS"], 0)
    return lo, hi, need, cnt


def _sel_shift(first, elt):
    """load_keys's shift of a list whose first score lies ``first``
    elements of ``elt`` bytes past a 16-byte boundary."""
    mis = first * elt % 16
    head = (16 - mis) % 16 // elt
    return (4 - head % 4) % 4


def _select_compact(keys, sh, lo, hi, need, cnt, first_bits, paths):
    """select_compact over a list of uint32 keys stored from slot ``sh``
    of 16-byte vectors: the positions of its winners in list order."""
    m = len(keys)
    if cnt != need and lo != hi:
        if cnt <= _SEL["CAND_K"]:
            paths.add("gathered")
            src = keys[(keys >= lo) & (keys <= hi)]
        else:
            paths.add("over the list")
            src = keys
        lo, hi, need, cnt = _sel_refine(src, lo, hi, need, cnt,
                                        32 - first_bits - _SEL["BITS"],
                                        paths)
    else:
        paths.add("all of the bin")
    one = lo == hi
    T = lo if one else lo - 1
    need_eq = need if one else 0
    if one and need < cnt:
        paths.add("ties cut")
    nq = (sh + m + 3) // 4
    k64 = np.zeros(4 * nq, np.int64)
    valid = np.zeros(4 * nq, bool)
    k64[sh:sh + m] = keys
    valid[sh:sh + m] = True
    q = np.arange(nq)
    if (not one or need == cnt) and nq <= _SEL["CHUNK"] * _SEL["THREADS"]:
        # compact_above: no tie is cut; each warp stages its winners
        thr = T - 1 if one else T
        won = (valid & (k64 > thr)).reshape(nq, 4)
        staged = np.bincount((q % _SEL["THREADS"]) // 32, won.sum(1),
                             minlength=_SEL_WARPS)
        if staged.max() <= _SEL["STAGE"]:
            paths.add("one pass")
            return np.flatnonzero(won.ravel()) - sh
        paths.add("staging overflow")
    # the compaction: cells of (round, warp), a lane's vector in each
    paths.add("two passes")
    gt = (valid & (k64 > T)).reshape(nq, 4)
    eq = (valid & (k64 == T)).reshape(nq, 4)
    slots = np.full(4 * nq, -1, np.int64)
    gt_run = eq_run = 0
    span = _SEL["CHUNK"] * _SEL["THREADS"]
    for q_lo in range(0, nq, span):
        qs = q[q_lo:q_lo + span]
        cell = ((qs - q_lo) // _SEL["THREADS"]) * _SEL_WARPS \
            + (qs % _SEL["THREADS"]) // 32
        g = np.bincount(cell, gt[qs].sum(1), minlength=_SEL["THREADS"])
        e = np.bincount(cell, eq[qs].sum(1), minlength=_SEL["THREADS"])
        cg = gt_run + np.cumsum(g) - g
        ce = eq_run + np.cumsum(e) - e
        # within a cell the lanes' vectors in order (lane = q % 32)
        for c in np.unique(cell):
            vs = qs[cell == c]
            assert np.array_equal(vs % 32, np.arange(len(vs)) + vs[0] % 32)
            gb, eb = int(cg[c]), int(ce[c])
            for v in vs:
                for j in range(4):
                    if gt[v, j] or (eq[v, j] and eb < need_eq):
                        slots[4 * v + j] = gb + min(eb, need_eq)
                    gb += int(gt[v, j])
                    eb += int(eq[v, j])
        gt_run += int(g.sum())
        eq_run += int(e.sum())
    won = np.flatnonzero(slots >= 0)
    total = gt_run + min(eq_run, need_eq)
    assert np.array_equal(slots[won], np.arange(total))   # row order
    return won - sh


def _sel_sort(keys, idx):
    """sort_out: up to SORT_SLOTS pairs the bitonic network over
    SORT_SLOTS slots (pads (0, 0xffffffff) last), else the radix sort
    (per pass, each warp counts its segment's digits, a scan in (digit,
    warp) order gives each warp its slots, a digit's lanes take them in
    order; a pass of one digit is skipped)."""
    m = len(keys)
    p = _SEL["SORT_SLOTS"]
    if m <= p:
        k = np.zeros(p, np.int64)
        x = np.full(p, 0xFFFFFFFF, np.int64)
        k[:m], x[:m] = keys, idx
        i = np.arange(p)
        s = 2
        while s <= p:
            j = s // 2
            while j:
                lo_ = i[(i & j) == 0]
                hi_ = lo_ | j
                first = (k[lo_] > k[hi_]) | ((k[lo_] == k[hi_])
                                             & (x[lo_] < x[hi_]))
                desc = (lo_ & s) == 0
                swap = np.where(desc, ~first, first)
                a, b = lo_[swap], hi_[swap]
                k[a], k[b] = k[b].copy(), k[a].copy()
                x[a], x[b] = x[b].copy(), x[a].copy()
                j //= 2
            s *= 2
        assert np.all(x[m:] == 0xFFFFFFFF)       # the pads go last
        return k[:m].astype(np.uint32), x[:m]
    seg = (-(-m // _SEL_WARPS) + 31) // 32 * 32
    warp = np.arange(m) // seg
    for shift in range(0, 32, _SEL["BITS"]):
        d = ((_SEL["BINS"] - 1) - ((keys >> np.uint32(shift))
                                   & np.uint32(_SEL["BINS"] - 1))
             ).astype(np.int64)
        if np.all(d == d[0]):
            continue
        wh = np.zeros((_SEL["BINS"], _SEL_WARPS), np.int64)
        np.add.at(wh, (d, warp), 1)
        off = (np.cumsum(wh.ravel()) - wh.ravel()).reshape(wh.shape)
        slot = np.empty(m, np.int64)
        for i in range(m):                    # in order: stable
            slot[i] = off[d[i], warp[i]]
            off[d[i], warp[i]] += 1
        assert np.array_equal(np.sort(slot), np.arange(m))
        out_k, out_i = np.empty_like(keys), np.empty_like(idx)
        out_k[slot], out_i[slot] = keys, idx
        keys, idx = out_k, out_i
    return keys, idx


def _model_resident(keys, k, sh, paths):
    """The resident route over one row's keys: (keys, indices) sorted."""
    first = _SEL["RES_BITS"]
    h = np.bincount((keys >> np.uint32(32 - first)).astype(np.int64),
                    minlength=_SEL["RES_BINS"])
    b, need, cnt, _ = _sel_pick(h, k)
    lo = b << (32 - first)
    win = _select_compact(keys, sh, lo, lo | ((1 << (32 - first)) - 1),
                          need, cnt, first, paths)
    assert len(win) == k
    return _sel_sort(keys[win], win)


def _model_long(keys, k, shift_of, paths):
    """The long route over one row's keys (``shift_of(first)``: the
    alignment shift of a tile from element ``first`` of the row)."""
    n = len(keys)
    first, ltile = _SEL["LONG_BITS"], _SEL["LTILE"]
    shift = 32 - first
    # launch 1: each cluster block's histogram, summed by slices; the
    # slice holding the k-th key picks its bin
    h = np.bincount((keys >> np.uint32(shift)).astype(np.int64),
                    minlength=_SEL["LONG_BINS"])
    slices = h.reshape(_SEL["CLUSTER"], -1)
    tot = slices.sum(axis=1)
    up = np.cumsum(tot[::-1])[::-1] - tot     # keys in higher slices
    r = int(np.flatnonzero((up < k) & (up + tot >= k))[0])
    b, need, cnt, above = _sel_pick(slices[r], k - int(up[r]))
    b += r * slices.shape[1]
    above += int(up[r])
    lo = b << shift
    hi = lo | ((1 << shift) - 1)
    assert (above, need + above) == (int((keys > hi).sum()), k)
    # launch 2: each tile's keys above the bin and its largest
    # min(bin keys, need) bin keys, in row order, to its region, and its
    # line (keys above, bin keys kept, the bin's least and largest key)
    cap = -(-min(ltile, k) // 4) * 4
    regions, lines = [], []
    for t in range(-(-n // ltile)):
        tk = keys[t * ltile:(t + 1) * ltile]
        inb = tk[(tk >= lo) & (tk <= hi)]
        bin_t, kept = len(inb), min(len(inb), need)
        tlo, thi = lo, hi
        if bin_t and inb.min() == inb.max():   # one key value
            paths.add("tile bin of one key")
            tlo = thi = int(inb.min())
            if not (tk > hi).any() and kept < bin_t:
                # the ties from the tile's start, a round at a time
                paths.add("ties from the tile's start")
        win = _select_compact(tk, shift_of(t * ltile), tlo, thi, kept,
                              bin_t, first, paths)
        gt = int((tk > hi).sum())
        assert len(win) == gt + kept <= cap
        regions.append((tk[win], win + t * ltile))
        lines.append((gt, kept, int(inb.min()) if bin_t else 0xFFFFFFFF,
                      int(inb.max()) if bin_t else 0))
    # launch 3: the regions gathered in order (when the row's bin is one
    # key value, each tile's keys above it and its share of the first
    # `need` bin keys: k keys), selected and sorted
    kept = sum(line[1] for line in lines)
    one = kept > 0 and (min(line[2] for line in lines)
                        == max(line[3] for line in lines))
    left = need
    for i, (rk_, ri_) in enumerate(regions):
        is_bin = rk_ <= hi
        quota = min(lines[i][1], left) if one else lines[i][1]
        left -= quota
        take = ~is_bin | (np.cumsum(is_bin) <= quota)
        regions[i] = (rk_[take], ri_[take])
    ck = np.concatenate([r[0] for r in regions])
    ci = np.concatenate([r[1] for r in regions])
    m = len(ck)
    assert np.all(np.diff(ci) > 0) and m >= k and (m == k or not one)
    span = max(m, _SEL["SORT_SLOTS"])
    paths.add("final in shared memory"
              if _SEL["FIXED_BYTES"] + 8 * (span + k)
              <= _SEL["RESIDENT_SMEM"] else "final in scratch")
    if one:
        paths.add("final of one key")
        lo = hi = lines[0][2] if lines[0][1] else min(
            line[2] for line in lines)
    win = _select_compact(ck, 0, lo, hi, need, need if one else kept,
                          first, paths)
    assert len(win) == k
    return _sel_sort(ck[win], ci[win])


def _model_select(x32, k, index_offset=0, paths=None, elt=4):
    """Top-k of each row of ``x32`` (f32; scores of ``elt`` bytes in a
    contiguous tensor) as the route of the wrapper's plan computes it;
    ``paths`` collects the route and the ways taken."""
    paths = set() if paths is None else paths
    rows, n = x32.shape
    p = plan(n, k)
    assert p.route in ("resident", "long")
    paths.add(p.route)
    vals = np.empty((rows, k), np.float32)
    idx = np.empty((rows, k), np.int64)
    for r in range(rows):
        keys = _np_keys(x32[r])
        if p.route == "resident":
            keys, pos = _model_resident(keys, k, _sel_shift(r * n, elt),
                                        paths)
        else:
            keys, pos = _model_long(
                keys, k, lambda f, r=r: _sel_shift(r * n + f, elt), paths)
        vals[r] = _np_values(keys)
        idx[r] = pos
    return vals, (idx + index_offset).astype(np.int32)


def _select_case(case, n, seed):
    """Scores (3, n) as f32, every value exact in bf16 and f16."""
    rng = np.random.default_rng(seed)
    shape = (3, n)
    if case == "ties_over_tiles":          # the k-th key tied across tiles
        return (rng.integers(0, 4, shape) / 4).astype(np.float32)
    if case == "one_value":
        return np.full(shape, 0.5, np.float32)
    if case == "all_neg_inf":
        return np.full(shape, -np.inf, np.float32)
    if case == "specials":                 # signed zeros and NaNs
        pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0],
                        np.float32)
        return rng.choice(pool, size=shape)
    if case == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    if case == "uniform":                  # U[0, 1): a wide first bin
        return (rng.integers(0, 1 << 11, shape) / (1 << 11)).astype(
            np.float32)
    raise ValueError(case)


def _assert_model(x32, k, want_route):
    """The model on x32 at k in f32, bf16 and f16 against topk_ref and
    lax.top_k; returns the paths it took."""
    paths = set()
    for dtype in ("f32", "bf16", "f16"):
        xj, xt = _exact(x32, dtype)
        ref = jax_topk_ref(xj, k, index_offset=3)
        _assert_same(topk_ref(xt, k, index_offset=3), ref)
        got = _model_select(to_f32(xt).numpy(), k, index_offset=3,
                            paths=paths, elt=xt.element_size())
        _assert_same((torch.from_numpy(got[0]), torch.from_numpy(got[1])),
                     ref)
    assert want_route in paths, paths
    return paths


#: a row of the device path's local execution (resident at every k that
#: fits), and a long row of four tiles, the last partial
_SEL_NS = {"resident": 20_000, "long": 3 * 16_384 + 10_848}


@pytest.mark.parametrize("case", ["ties_over_tiles", "one_value",
                                  "all_neg_inf", "specials", "normal"])
@pytest.mark.parametrize("k", [257, 512, 1280, "n-1", "n"])
@pytest.mark.parametrize("where", ["resident", "long"])
def test_topk_select_model_matches_reference(case, k, where):
    """The select routes, modelled step by step, equal the port's plain
    version and lax.top_k bit for bit, in f32, bf16 and f16 (a k of n -
    1 or n does not fit the resident route: the long route's final
    select and sort run in scratch)."""
    assert _SEL["LTILE"] == 16_384 and _SEL["MAX_K"] == MAX_K
    n = _SEL_NS[where]
    k = {"n-1": n - 1, "n": n}.get(k, k)
    route = where if plan(n, k).route == where else "long"
    _assert_model(_select_case(case, n, seed=k), k, route)


def _resident_max_n(k):
    """The largest n the resident route takes at k."""
    return ((_wrapper.RESIDENT_SMEM - _wrapper.FIXED_BYTES - 8 * k) // 4
            - 4)


@pytest.mark.parametrize("case", ["normal", "uniform", "one_value",
                                  "ties_over_tiles"])
@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("k", [257, 4096])
def test_topk_select_model_at_the_route_threshold(case, delta, k):
    """Rows one short of, at and one past the largest the resident route
    takes: the route flips there, and both agree with the reference."""
    n = _resident_max_n(k) + delta
    route = "resident" if delta <= 0 else "long"
    assert plan(n, k).route == route
    _assert_model(_select_case(case, n, seed=n)[:1], k, route)


def test_topk_select_model_takes_every_path():
    """The inputs above drive the model through every way: all of the
    bin, its keys gathered or narrowed over the list, a bin of one key
    value, ties cut at the k-th key, the long route's final in shared
    memory and in scratch, both sorts."""
    seen = {}
    for where, n in _SEL_NS.items():
        for case in ("normal", "uniform", "one_value", "ties_over_tiles"):
            for k in (512, n):
                p = set()
                _model_select(_select_case(case, n, seed=1)[:1], k,
                              paths=p)
                seen[(where, case, k)] = p
    assert {"gathered", "one pass"} <= seen[("resident", "normal", 512)]
    assert "two passes" in seen[("resident", "one_value", 512)]
    assert "staging overflow" in seen[("resident", "normal", 20_000)]
    assert {"over the list", "one key", "ties cut"} <= seen[
        ("resident", "one_value", 512)]
    assert "all of the bin" in seen[("resident", "one_value", 20_000)]
    assert {"long", "final in shared memory"} <= seen[("long", "normal",
                                                       512)]
    assert {"tile bin of one key", "ties from the tile's start",
            "final of one key", "final in shared memory"} <= seen[
        ("long", "one_value", 512)]
    assert "final in scratch" in seen[("long", "normal", _SEL_NS["long"])]
    # a heavy bin of distinct keys (all in one first-digit bin) narrows
    # over the list by bytes, to exactly the keys wanted
    x = (1 + np.random.default_rng(1).random((1, 20_000)) / 8).astype(
        np.float32)
    p = set()
    got = _model_select(x, 512, paths=p)
    _assert_same((torch.from_numpy(got[0]), torch.from_numpy(got[1])),
                 topk_ref(torch.from_numpy(x), 512))
    assert "over the list" in p and "one key" not in p


def test_topk_plan_routes():
    """k up to MAX_K takes the tile route; a larger k the resident route
    while the row, its winners and the room fit RESIDENT_SMEM, else the
    long route with its tiles and scratch; the wrapper's constants,
    formulas and argument list are csrc/topk_select.cu's."""
    for name in ("FIXED_BYTES", "RESIDENT_SMEM", "LTILE", "STATE", "LINE",
                 "SORT_SLOTS"):
        assert _SEL[name] == getattr(_wrapper, name), name
    assert "return FIXED_BYTES + 4 * resident_span(n, k) + 8 * k;" in _SEL_SRC
    assert ("const long long sort = 2 * (k > SORT_SLOTS ? k : SORT_SLOTS);"
            in _SEL_SRC)
    assert "return n + 4 > sort ? n + 4 : sort;" in _SEL_SRC
    assert "if (resident_bytes(n, k) <= RESIDENT_SMEM) {" in _SEL_SRC
    assert "*tiles = cdiv(n, LTILE);" in _SEL_SRC
    assert ("*words = 2 * cdiv(STATE + LINE * *tiles + 4 * *tiles * cap "
            "+ 2 * k, 4);" in _SEL_SRC)
    assert "const long long cap = round4(k < LTILE ? k : LTILE);" in _SEL_SRC
    assert "k <= MAX_K || k > n" in _SEL_SRC
    assert "tiles != want_tiles" in _SEL_SRC
    params = re.search(r"extern \"C\" int NAME\(([^)]*)\)",
                       _SEL_SRC).group(1)
    assert len(params.split(",")) == len(_wrapper._ARGTYPES)
    assert plan(20_000, MAX_K).route == "tiles"
    # local execution (k 512, 4096) and CN* (64 x 700) are resident; CN
    # at k_frac 1e-3 is long
    for n, k in ((20_000, 512), (20_000, 4096), (44_800, 700),
                 (257, 257)):
        assert plan(n, k) == ("resident", 0, 0), (n, k)
    for n, k, tiles in ((1_280_000, 1_280, 79), (1_280_000, 512, 79),
                        (20_000, 20_000, 2), (60_000, 257, 4)):
        cap = -(-min(16_384, k) // 4) * 4
        assert plan(n, k) == ("long", tiles, 2 * -(-(4 + 4 * tiles
                                                    + 4 * tiles * cap
                                                    + 2 * k) // 4))
    n = _resident_max_n(512)
    assert n == 52_860
    assert (plan(n, 512).route, plan(n + 1, 512).route) == ("resident",
                                                            "long")


def test_device_engine_large_k_matches_reference(devices8, tmp_path):
    """``DeviceEngine`` at ``QuerySpec(k=300)``, above the tile route's
    MAX_K, on the port's CPU path against the reference's DeviceEngine
    on 8 peers (one subprocess): every schedule, CN and CN*, bit for
    bit, on lattice scores with ties and signed zeros."""
    from repro_torch.core import mesh as M
    from repro_torch.engine import DeviceEngine, QuerySpec
    rng = np.random.default_rng(21)
    scores = (rng.integers(-40, 40, (2, 8 * 512)) / 8).astype(np.float32)
    scores[0, ::7] = -0.0
    np.save(tmp_path / "s.npy", scores)
    devices8(f"""
import numpy as np
from repro.engine import DeviceEngine, QuerySpec
from repro.jaxcompat import make_mesh
s = np.load({str(tmp_path / 's.npy')!r})
m8 = make_mesh((8,), ("model",))
out = {{}}
for name, sch, pol in {_LARGE_K_RUNS!r}:
    r = DeviceEngine(m8, schedule=sch).run(QuerySpec(k=300), pol, scores=s)
    out[name + "_v"], out[name + "_i"] = (np.asarray(r.values),
                                          np.asarray(r.indices))
np.savez({str(tmp_path / 'out.npz')!r}, **out)
""", timeout=600)
    want = dict(np.load(tmp_path / "out.npz"))
    mesh = M.make_mesh((8,), ("model",), device="cpu")
    for name, sch, pol in _LARGE_K_RUNS:
        res = DeviceEngine(mesh, schedule=sch).run(QuerySpec(k=300), pol,
                                                   scores=scores)
        assert res.values.shape == (2, 300)
        np.testing.assert_array_equal(_bits(res.values.numpy()),
                                      _bits(want[name + "_v"]))
        np.testing.assert_array_equal(res.indices.numpy(),
                                      want[name + "_i"])


_LARGE_K_RUNS = [("halving", "halving", "fd-dynamic"),
                 ("doubling", "doubling", "fd-dynamic"),
                 ("ring", "ring", "fd-dynamic"),
                 ("cn", "halving", "cn"), ("cn-star", "halving", "cn-star")]
