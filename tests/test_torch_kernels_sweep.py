"""The port's forward-sweep kernels (plain PyTorch versions + dispatch)
against the reference package's oracles and Pallas kernels in
interpret mode.

Mirrors tests/test_kernels_sweep.py.  Inputs are made with numpy from a
seed and handed to both packages; every comparison is exact: the sweep
is single adds and min/max/select in f64.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import jaxcompat
from repro.kernels.sweep import wait_propagate as jax_wait_propagate
from repro.kernels.sweep.ref import arrivals_ref as jax_arrivals_ref
from repro.kernels.sweep.ref import wait_ref as jax_wait_ref
from repro.kernels.sweep.sweep import arrivals_pallas, wait_pallas
from repro_torch.kernels.sweep import (arrivals_cuda, arrivals_ref,
                                       level_arrivals, wait_cuda,
                                       wait_propagate, wait_ref)

T = torch.from_numpy


def _arrival_inputs(rng, E, L, Lp, dtype=np.float64):
    tq_prev = rng.random((E, Lp)).astype(dtype)
    dn = rng.random((E, L)).astype(dtype)
    par_pos = rng.integers(0, Lp, L).astype(np.int64)
    return tq_prev, dn, par_pos


def _wait_inputs(rng, E, L, dtype=np.float64):
    return tuple(rng.random((E, L)).astype(dtype) for _ in range(3))


@pytest.mark.parametrize("E,L,Lp", [(1, 1, 1), (3, 7, 4), (8, 33, 17)])
def test_arrivals_matches_reference_f64(E, L, Lp):
    rng = np.random.default_rng(0)
    tq_prev, dn, par_pos = _arrival_inputs(rng, E, L, Lp)
    a = level_arrivals(T(tq_prev), T(dn), T(par_pos)).numpy()
    # int32 positions (the plan's width at 100k peers) give the same bits
    a32 = level_arrivals(T(tq_prev), T(dn),
                         T(par_pos.astype(np.int32))).numpy()
    with jaxcompat.enable_x64():
        a_ref = np.asarray(jax_arrivals_ref(tq_prev, dn, par_pos))
        a_pl = np.asarray(arrivals_pallas(tq_prev, dn, par_pos,
                                          interpret=True))
    assert a.dtype == np.float64
    for other in (a32, a_ref, a_pl, tq_prev[:, par_pos] + dn):
        np.testing.assert_array_equal(a, other)


@pytest.mark.parametrize("E,L", [(1, 1), (4, 9), (6, 40)])
def test_wait_matches_reference_f64(E, L):
    rng = np.random.default_rng(1)
    own, all_in, deadline = _wait_inputs(rng, E, L)
    s = wait_propagate(T(own), T(all_in), T(deadline)).numpy()
    with jaxcompat.enable_x64():
        s_ref = np.asarray(jax_wait_ref(own, all_in, deadline))
        s_pl = np.asarray(wait_pallas(own, all_in, deadline, None,
                                      interpret=True))
    assert s.dtype == np.float64
    expr = np.minimum(np.maximum(own, all_in), np.maximum(deadline, own))
    for other in (s_ref, s_pl, expr):
        np.testing.assert_array_equal(s, other)


def test_wait_churn_send_masks_dead_rows():
    """The churn variant: ``send = s`` where the peer is alive at its
    send time (``death >= s``) and +inf elsewhere — equal to the
    reference's oracle and Pallas kernel and to masking by hand."""
    rng = np.random.default_rng(3)
    own, all_in, deadline = _wait_inputs(rng, 5, 11)
    death = rng.random((5, 11))
    s, snd = (x.numpy() for x in wait_propagate(
        T(own), T(all_in), T(deadline), death=T(death)))
    with jaxcompat.enable_x64():
        s_ref, snd_ref = jax_wait_propagate(own, all_in, deadline,
                                            death=death, use_pallas=False)
        s_pl, snd_pl = wait_pallas(own, all_in, deadline, death,
                                   interpret=True)
    for a, b in ((s, s_ref), (s, s_pl), (snd, snd_ref), (snd, snd_pl)):
        np.testing.assert_array_equal(a, np.asarray(b))
    alive = death >= s
    np.testing.assert_array_equal(snd, np.where(alive, s, np.inf))
    assert not alive.all() and alive.any()   # both branches hit


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_sweep_plain_versions_preserve_dtype(dtype):
    """f64 / f32 / bf16 inputs come back in the same dtype — no silent
    upcast (the kernels take one dtype per call)."""
    rng = np.random.default_rng(2)
    tq_prev, dn, par_pos = _arrival_inputs(rng, 3, 5, 4)
    a = arrivals_ref(T(tq_prev).to(dtype), T(dn).to(dtype), T(par_pos))
    assert a.dtype == dtype
    own, all_in, deadline = (T(x).to(dtype)
                             for x in _wait_inputs(rng, 3, 5))
    death = T(rng.random((3, 5))).to(dtype)
    assert wait_ref(own, all_in, deadline).dtype == dtype
    s, snd = wait_ref(own, all_in, deadline, death)
    assert s.dtype == dtype and snd.dtype == dtype


@settings(max_examples=10, deadline=None)
@given(E=st.integers(1, 6), L=st.integers(1, 24), Lp=st.integers(1, 24),
       seed=st.integers(0, 999))
def test_sweep_property_parity(E, L, Lp, seed):
    """Random shapes: the port's plain versions == the reference's
    oracles, bit for bit, for both kernels including the churn send."""
    rng = np.random.default_rng(seed)
    tq_prev, dn, par_pos = _arrival_inputs(rng, E, L, Lp)
    own, all_in, deadline = _wait_inputs(rng, E, L)
    death = rng.random((E, L))
    s, snd = wait_ref(T(own), T(all_in), T(deadline), T(death))
    with jaxcompat.enable_x64():
        np.testing.assert_array_equal(
            arrivals_ref(T(tq_prev), T(dn), T(par_pos)).numpy(),
            np.asarray(jax_arrivals_ref(tq_prev, dn, par_pos)))
        s2, snd2 = jax_wait_propagate(own, all_in, deadline, death=death,
                                      use_pallas=False)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s2))
    np.testing.assert_array_equal(snd.numpy(), np.asarray(snd2))


def test_sweep_routes_by_device_without_fallback():
    """CPU tensors take the plain versions, other non-CUDA devices
    raise, and the CUDA wrappers refuse CPU tensors."""
    x = torch.zeros(2, 3, dtype=torch.float64)
    pp = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="no path"):
        level_arrivals(x.to("meta"), x.to("meta"), pp.to("meta"))
    with pytest.raises(ValueError, match="no path"):
        wait_propagate(x.to("meta"), x.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        arrivals_cuda(x, x, pp)
    with pytest.raises(ValueError, match="CUDA"):
        wait_cuda(x, x, x)
