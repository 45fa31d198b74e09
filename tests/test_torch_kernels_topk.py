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
