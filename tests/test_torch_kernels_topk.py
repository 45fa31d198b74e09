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
    assert plan(TILE + 1, 257).route == "select"


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
# The select route (k > MAX_K, csrc/topk_select.cu), modelled step by
# step in numpy: the radix select of the row's k-th key over the row (the
# source's digit widths), the winners above it in any order (the kernel
# places them by atomics), the tied keys by the tiles' quotas in index
# order, the LSD radix sort of the words; held to topk_ref and
# lax.top_k.
# ---------------------------------------------------------------------------

_SEL_SRC = (Path(_wrapper.__file__).resolve().parents[1] / "csrc"
            / "topk_select.cu").read_text()
_SEL = {name: int(v) for name, v in
        re.findall(r"constexpr int (\w+) = (\d+);", _SEL_SRC)}
_SEL.update({name: 1 << _SEL[v] for name, v in
             re.findall(r"constexpr int (\w+) = 1 << (\w+);", _SEL_SRC)})


def _model_select(x32, k, index_offset=0, seed=0):
    """Top-k of each row of ``x32`` (f32) as the select route computes
    it."""
    rows, n = x32.shape
    route, tiles, _ = plan(n, k)
    assert route == "select" and tiles == -(-n // _SEL["SEL_TILE"])
    first, bits = _SEL["SEL_FIRST_BITS"], _SEL["SEL_BITS"]
    assert first + 2 * bits == 32
    rng = np.random.default_rng(seed)
    vals = np.empty((rows, k), np.float32)
    idx = np.empty((rows, k), np.int64)
    for r in range(rows):
        keys = _np_keys(x32[r]).astype(np.int64)
        prefix, need = 0, k
        for shift, width in ((32 - first, first), (bits, bits), (0, bits)):
            top = shift + width           # digits above this one found
            live = keys if top >= 32 else keys[(keys >> top)
                                               == (prefix >> top)]
            h = np.bincount((live >> shift) & ((1 << width) - 1),
                            minlength=1 << width)
            above = np.cumsum(h[::-1])[::-1] - h
            b = int(np.flatnonzero((above < need) & (above + h >= need))[0])
            prefix |= b << shift
            need -= int(above[b])
        gt = np.flatnonzero(keys > prefix)
        assert len(gt) == k - need and need >= 1
        # each tile's equal keys, and its quota after the earlier tiles'
        eq = keys == prefix
        per = np.add.reduceat(eq, np.arange(0, n, _SEL["SEL_TILE"]))
        before = np.cumsum(per) - per
        quota = np.clip(need - before, 0, per)
        ties = np.concatenate([
            np.flatnonzero(eq[t * _SEL["SEL_TILE"]:
                              (t + 1) * _SEL["SEL_TILE"]])[:q]
            + t * _SEL["SEL_TILE"] for t, q in enumerate(quota)])
        assert len(ties) == need
        order = rng.permutation(len(gt))       # the atomics' slot order
        w = np.concatenate([_words(keys[gt[order]].astype(np.uint32),
                                   gt[order]),
                            _words(keys[ties].astype(np.uint32), ties)])
        for shift in range(0, 64, _SEL["SORT_BITS"]):
            d = (np.uint64(_SEL["SORT_BINS"] - 1)
                 - ((w >> np.uint64(shift))
                    & np.uint64(_SEL["SORT_BINS"] - 1)))
            if np.all(d == d[0]):
                continue                       # one digit: order stays
            w = w[np.argsort(d, kind="stable")]
        vals[r] = _np_values(w >> np.uint64(32))
        idx[r] = (0xFFFFFFFF - (w & np.uint64(0xFFFFFFFF))).astype(np.int64)
    return vals, (idx + index_offset).astype(np.int32)


_SEL_N = 2 * _SEL["SEL_TILE"] + 5          # three tiles, the last of 5


def _select_case(case, seed):
    """Scores (3, _SEL_N) as f32, every value exact in bf16 and f16."""
    rng = np.random.default_rng(seed)
    shape = (3, _SEL_N)
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
    raise ValueError(case)


@pytest.mark.parametrize("case", ["ties_over_tiles", "one_value",
                                  "all_neg_inf", "specials", "normal"])
@pytest.mark.parametrize("k", [257, 512, 1000, _SEL_N - 1, _SEL_N])
def test_topk_select_model_matches_reference(case, k):
    """The select route, modelled step by step, equals the port's plain
    version and lax.top_k bit for bit, in f32, bf16 and f16."""
    assert _SEL["SEL_TILE"] == 16384 and _SEL["MAX_K"] == MAX_K
    x32 = _select_case(case, seed=k)
    for dtype in ("f32", "bf16", "f16"):
        xj, xt = _exact(x32, dtype)
        ref = jax_topk_ref(xj, k, index_offset=3)
        _assert_same(topk_ref(xt, k, index_offset=3), ref)
        got = _model_select(to_f32(xt).numpy(), k, index_offset=3, seed=k)
        _assert_same((torch.from_numpy(got[0]), torch.from_numpy(got[1])),
                     ref)


def test_topk_plan_routes():
    """k up to MAX_K takes the tile route, a larger k the select route
    with its tiles and scratch as csrc/topk_select.cu plans them, and
    the wrapper's constants and argument list are that source's."""
    for name in ("SEL_TILE", "SEL_FIRST_BINS", "SEL_STATE"):
        assert _SEL[name] == getattr(_wrapper, name), name
    assert "*words = 2 * k + SEL_FIRST_BINS / 2 + SEL_STATE / 2 + " \
           "cdiv(*tiles, 2);" in _SEL_SRC
    assert "k <= MAX_K || k > n" in _SEL_SRC
    assert "tiles != want_tiles" in _SEL_SRC
    params = re.search(r"extern \"C\" int NAME\(([^)]*)\)",
                       _SEL_SRC).group(1)
    assert len(params.split(",")) == len(_wrapper._ARGTYPES)
    assert plan(20_000, MAX_K).route == "tiles"
    for n, k, tiles in ((20_000, 512, 2), (20_000, 4096, 2),
                        (1_280_000, 1_280, 79), (257, 257, 1)):
        assert plan(n, k) == ("select", tiles, 2 * k + 2048 + 2
                              + -(-tiles // 2))


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
