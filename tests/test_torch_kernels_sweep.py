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


# ---------------------------------------------------------------------------
# A numpy model of the arrivals kernel's launch (csrc/sweep.cu), which
# cannot run here: the wrapper's plan, the kernel's constants read from
# the source, every block, thread and unrolled load as the two kernels
# take them.  It checks that each (e, l) is written exactly once, that
# every read stays inside row e (dn, out: [0, L); tq_prev: [0, L_prev)),
# that a 16-byte slot starts on a 16-byte boundary, and the values.
# ---------------------------------------------------------------------------

import re  # noqa: E402
from pathlib import Path  # noqa: E402

import repro_torch.kernels.sweep.sweep as _wrapper  # noqa: E402
from repro_torch.kernels.sweep.sweep import arrivals_plan  # noqa: E402

_SRC = (Path(_wrapper.__file__).resolve().parents[1] / "csrc"
        / "sweep.cu").read_text()
_CONST = {name: int(v) for name, v in re.findall(
    r"constexpr (?:int|long long) (\w+) = (\d+)(?:LL)?;", _SRC)}
_CONST.update({name: 1 << int(v) for name, v in re.findall(
    r"constexpr long long (\w+) = 1LL << (\d+);", _SRC)})

# the path's six level shapes (origin 0 of the 100k-peer overlay of
# chip_smoke.py), then the plan's edges
_LEVELS = [(32, 308, 1), (32, 3837, 308), (32, 24120, 3837),
           (32, 51529, 24120), (32, 19690, 51529), (32, 515, 19690)]
_EDGES = [(1, 51529, 24120), (32, 1, 7), (32, 1000, 1), (37, 24120, 3837),
          (13, 1001, 333), (70_000, 3, 5)]


def _model_arrivals(tq, dn, pp, plan):
    """``out`` as the planned launch writes it, and each output's write
    count; asserts every read in row bounds and every 16-byte slot
    aligned (``dn`` and ``out`` taken to start on 16-byte boundaries,
    as ``aligned`` says when ``vec`` > 1)."""
    E, Lp = tq.shape
    L = dn.shape[1]
    assert plan.grid_y * plan.grid_z >= E
    rows = np.arange(plan.grid_y * plan.grid_z)   # e = z * grid_y + y
    e = rows[rows < E][:, None]                   # rows past E return
    if not plan.staged:
        assert plan.vec == 1 and plan.threads == _CONST["ARR_THREADS"]
        assert plan.slots == plan.threads and plan.smem == 0
        l = (np.arange(plan.grid_x)[:, None] * plan.threads
             + np.arange(plan.threads)[None, :]).ravel()
        l = l[l < L][None, :]                     # threads past L return
        e, l = np.broadcast_arrays(e, l)
    else:
        vec, T = plan.vec, plan.threads
        assert T == _CONST["STAGE_THREADS"]
        # the plan's element size: the parent row in shared memory, and
        # a slot of 16 bytes or one column
        size, rest = divmod(plan.smem, Lp)
        assert rest == 0 and size in (2, 4, 8)
        assert plan.smem <= _CONST["SMEM_MAX"]
        assert vec in (1, _CONST["VEC_BYTES"] // size)
        U = _CONST["STAGE_ELEMS"] // vec
        s = (e * L) % vec                         # row e's slot shift
        row_end = (L + s + vec - 1) // vec
        es, ls = [], []
        for x in range(plan.grid_x):
            # thread t walks j0 = x * per + t, + T * U, its U slots
            # j0 + u * T a batch, below the block's cut at the row's end
            jend = np.minimum((x + 1) * plan.slots, row_end)
            steps = max(0, -(-(int(jend.max()) - x * plan.slots) // (T * U)))
            j = (x * plan.slots + np.arange(T)[:, None, None]
                 + np.arange(steps)[None, :, None] * T * U
                 + np.arange(U)[None, None, :] * T).ravel()
            j = np.sort(j[j < jend.max()])[None, :]
            keep = j < jend
            l0 = vec * j - s
            full = keep & (vec > 1) & (l0 >= 0) & (l0 + vec <= L)
            # a 16-byte slot starts on a 16-byte boundary of the flat
            # array (flat index a multiple of vec)
            assert np.all(((e * L + l0) % vec)[full] == 0)
            l = l0[:, :, None] + np.arange(vec)[None, None, :]
            ok = keep[:, :, None] & (l >= 0) & (l < L)
            ee = np.broadcast_to(e[:, :, None], l.shape)
            es.append(ee[ok])
            ls.append(l[ok])
        e, l = np.concatenate(es), np.concatenate(ls)
    assert pp[l].min(initial=0) >= 0 and pp[l].max(initial=0) < Lp
    writes = np.zeros((E, L), np.int64)
    np.add.at(writes, (e, l), 1)
    out = np.zeros((E, L), dn.dtype)
    out[e, l] = tq[e, pp[l]] + dn[e, l]
    return out, writes


def _plans(E, L, Lp):
    """Every plan the wrapper makes for the shape: each element size,
    alignment and staging request it can plan."""
    out = []
    for size in (8, 4, 2):
        for aligned in (True, False):
            for staged in (None, False, True):
                try:
                    out.append(arrivals_plan(E, L, Lp, size, aligned=aligned,
                                             staged=staged))
                except ValueError:
                    assert staged and Lp * size > _CONST["SMEM_MAX"]
    return out


@pytest.mark.parametrize("E,L,Lp", _LEVELS + _EDGES)
@pytest.mark.parametrize("idx", [np.int32, np.int64])
def test_arrivals_launch_model_writes_each_output_once(E, L, Lp, idx):
    """Every plan of the level covers each (e, l) exactly once, reads
    inside row e, keeps its 16-byte slots aligned, and gives
    ``tq_prev[:, par_pos] + dn`` bit for bit."""
    rng = np.random.default_rng(E + L + Lp)
    tq, dn, par_pos = _arrival_inputs(rng, E, L, Lp)
    par_pos = par_pos.astype(idx)
    ref = tq[:, par_pos] + dn
    seen = set()
    for plan in {tuple(p): p for p in _plans(E, L, Lp)}.values():
        out, writes = _model_arrivals(tq, dn, par_pos, plan)
        assert writes.min() == 1 and writes.max() == 1, plan
        np.testing.assert_array_equal(out, ref)
        seen.add((plan.staged, plan.vec))
    assert (False, 1) in seen
    if Lp * 2 <= _CONST["SMEM_MAX"]:
        assert {(True, 8), (True, 1)} <= seen   # bf16 slots, unaligned


def test_arrivals_plan_at_the_path_levels():
    """The plan's choice at the path's levels (E = 32, f64, aligned):
    the two large levels dense in children are staged with 16-byte
    slots (132 // 32 = 4 blocks a row); the small ones (bound by their
    latency) and the sparse ones are gathered, a column a thread."""
    staged = [arrivals_plan(E, L, Lp, 8).staged for E, L, Lp in _LEVELS]
    assert staged == [False, False, True, True, False, False]
    p = arrivals_plan(32, 51529, 24120, 8)
    assert (p.vec, p.grid_x, p.grid_y, p.grid_z, p.slots, p.smem) == (
        2, 4, 32, 1, 6442, 192960)
    assert arrivals_plan(32, 19690, 51529, 8) == (
        1, False, False, 512, 39, 32, 1, 512, 0)
    # an unaligned dn: a staged slot of one column
    assert arrivals_plan(32, 24120, 3837, 8, aligned=False).vec == 1
    # bf16 slots of 8; f32 of 4
    assert arrivals_plan(32, 24120, 3837, 2, staged=True).vec == 8
    assert arrivals_plan(32, 24120, 3837, 4, staged=True).vec == 4


def test_arrivals_plan_edges():
    """64-bit offsets exactly where E * max(L, Lp) + WIDE_MARGIN reaches
    2**31; rows past MAX_GRID_Y on z; what cannot be planned raises."""
    margin, top = _CONST["WIDE_MARGIN"], 2 ** 31
    assert not arrivals_plan(1, top - margin - 1, 9, 8).wide
    assert arrivals_plan(1, top - margin, 9, 8).wide
    assert arrivals_plan(32, 2 ** 26, 1000, 8).wide
    assert arrivals_plan(2, 5, top // 2, 8).wide           # a wide parent
    p = arrivals_plan(70_000, 3, 5, 8, staged=False)
    assert (p.grid_y, p.grid_z) == (65_535, 2)
    assert arrivals_plan(65_535 ** 2, 1, 1, 8).grid_z == 65_535
    for bad in ((65_535 ** 2 + 1, 1, 1), (0, 5, 5), (3, 0, 5), (3, 5, 0)):
        with pytest.raises(ValueError):
            arrivals_plan(*bad, 8)
    too_wide = _CONST["SMEM_MAX"] // 8 + 1                 # f64 parents
    with pytest.raises(ValueError, match="cannot be staged"):
        arrivals_plan(32, 10 * too_wide, too_wide, 8, staged=True)
    assert not arrivals_plan(32, 10 * too_wide, too_wide, 8).staged


def test_arrivals_plan_matches_launcher_source():
    """The wrapper's constants are the kernel's, its argument list is
    the launcher's, and the launcher recomputes the plan and refuses any
    other (on the card, chip_smoke.py phase 2 also holds the library's
    exported plan equal to arrivals_plan at every shape it checks)."""
    for name in ("ARR_THREADS", "STAGE_THREADS", "STAGE_ELEMS", "SMS",
                 "SMEM_MAX", "VEC_BYTES", "SECTOR", "STAGE_MIN_BYTES",
                 "MAX_GRID_Y", "WIDE_MARGIN"):
        assert _CONST[name] == getattr(_wrapper, name), name
    assert "p.vec != vec || p.wide != wide" in _SRC
    assert "make_plan(E, L, Lp, static_cast<int>(sizeof(T)), aligned," in _SRC
    params = re.search(r"#define REPRO_ARRIVALS_LAUNCHER\(NAME, T, I\)(.*?)"
                       r"\{", _SRC, re.S).group(1)
    assert params.count(",") + 1 == len(_wrapper._ARRIVALS_ARGTYPES)
    fields = re.search(r"struct Plan \{\s*long long ([^;]*);", _SRC).group(1)
    assert [f.strip() for f in fields.split(",")] == list(
        _wrapper.ArrivalsPlan._fields)
    # the profiler's sum over the arrivals kernels finds both
    assert {"arrivals_kernel(", "arrivals_kernel_staged("} <= set(
        re.findall(r"\b(arrivals_kernel\w*\()", _SRC))
