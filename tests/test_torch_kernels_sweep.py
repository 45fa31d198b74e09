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


# ---------------------------------------------------------------------------
# The wait rule's NaNs and signed zeros: jnp.maximum / jnp.minimum give
# NaN for a NaN operand and order -0.0 below +0.0; the port's plain
# version (and its kernel) keep that rule, returning the first NaN
# operand in the expression's order with its bits.
# ---------------------------------------------------------------------------

import itertools  # noqa: E402

import jax.numpy as jnp  # noqa: E402

_SPECIAL_VALUES = [0.0, -0.0, 0.5, np.inf, -np.inf, np.nan]
_WAIT_DTYPES = {"f64": (np.float64, torch.float64, np.int64),
                "f32": (np.float32, torch.float32, np.int32),
                "bf16": (jnp.bfloat16, torch.bfloat16, np.int16)}
# a NaN of its own for each operand position (sign and payload), so the
# NaN that comes out names the operand it came from
_NAN_BITS = {
    name: np.array(u, {"f64": np.uint64, "f32": np.uint32,
                       "bf16": np.uint16}[name])
    .view(_WAIT_DTYPES[name][2]).tolist()
    for name, u in (
        ("f64", [0x7FF8000000000001, 0xFFF8000000000002,
                 0xFFF8000000000003, 0x7FF8000000000004]),
        ("f32", [0x7FC00001, 0xFFC00002, 0xFFC00003, 0x7FC00004]),
        ("bf16", [0x7FC1, 0xFFC2, 0xFFC3, 0x7FC4]))}


def _grid(dtype, n_ops):
    """Every combination of the six specials over ``n_ops`` operands, as
    numpy arrays (one per operand, JAX's dtype) whose NaNs carry their
    operand's own bits."""
    npdt, _, bits = _WAIT_DTYPES[dtype]
    combos = np.array(list(itertools.product(range(6), repeat=n_ops)))
    ops = []
    for j in range(n_ops):
        v = np.array(_SPECIAL_VALUES, np.float32)[combos[:, j]].astype(npdt)
        b = v.view(bits).copy()
        b[np.isnan(v.astype(np.float32))] = _NAN_BITS[dtype][j]
        ops.append(b.view(npdt).reshape(6, -1))
    return ops


_TORCH_BITS = {np.int64: torch.int64, np.int32: torch.int32,
               np.int16: torch.int16}


def _torch_of(a, dtype):
    """The numpy operand ``a`` as a torch tensor of the same bits."""
    _, tdt, bits = _WAIT_DTYPES[dtype]
    return torch.from_numpy(a.view(bits).copy()).view(tdt)


def _port_bits(t, bits):
    """A port output's bits as numpy integers."""
    return t.view(_TORCH_BITS[bits]).numpy()


def _np_nan(x):
    return np.isnan(x.astype(np.float64))


def _np_key(x, bits):
    """``kernels/order.py``'s total-order key, on the bits in numpy."""
    b = x.view(bits)
    return b ^ ((b >> (8 * b.itemsize - 1)) & np.iinfo(bits).max)


def _np_pick(a, b, b_wins):
    return np.where(_np_nan(a), a, np.where(_np_nan(b) | b_wins, b, a))


def _np_wait(o, a, d, bits):
    """The rule in numpy on the bits: a NaN operand wins (the first in
    order), else the IEEE total order decides max and min."""
    def k(x):
        return _np_key(x, bits)
    m1 = _np_pick(o, a, k(o) < k(a))
    m2 = _np_pick(d, o, k(d) < k(o))
    return _np_pick(m1, m2, k(m2) < k(m1))


def _same_ieee(got, want, bits):
    """``got`` (the port's bits) against ``want`` (JAX's values): NaNs at
    the same places, every other element the same bits (values and zero
    signs)."""
    want = np.ascontiguousarray(want)
    gn, wn = _np_nan(got.view(want.dtype)), _np_nan(want)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(got[~gn], want.view(bits)[~wn])


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_wait_specials_match_reference(dtype):
    """All 216 triples of {+0, -0, 0.5, +inf, -inf, NaN}: the port's
    ``wait_ref`` and ``wait_propagate`` equal the reference's oracle and
    ``wait_pallas`` (interpret mode): NaNs at the same places, the same
    values and zero signs.  The NaN that comes out is the first NaN
    operand of ``min(max(own, all_in), max(deadline, own))``, its bits
    kept (the numpy model of the rule, which the kernel follows)."""
    _, _, bits = _WAIT_DTYPES[dtype]
    own, all_in, dl = _grid(dtype, 3)
    with jaxcompat.enable_x64():
        want = np.asarray(jax_wait_ref(own, all_in, dl))
        pallas = np.asarray(wait_pallas(own, all_in, dl, None,
                                        interpret=True))
    ts = [_torch_of(x, dtype) for x in (own, all_in, dl)]
    for port in (wait_ref(*ts), wait_propagate(*ts)):
        got = _port_bits(port, bits)
        for ref in (want, pallas):
            _same_ieee(got, ref, bits)
        np.testing.assert_array_equal(
            got, _np_wait(own, all_in, dl, bits).view(bits))
    # the zero ties that torch.maximum / torch.minimum leave open
    assert (got.view(want.dtype) == 0).any()
    nan = _np_nan(want)
    assert set(got[nan].tolist()) == set(_NAN_BITS[dtype][:3])


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_wait_churn_specials_match_reference(dtype):
    """All 1,296 quads with a death time: ``s`` as above and ``send =
    where(death >= s, s, inf)``, against the reference's oracle and
    ``wait_pallas``'s churn variant."""
    _, _, bits = _WAIT_DTYPES[dtype]
    own, all_in, dl, death = _grid(dtype, 4)
    with jaxcompat.enable_x64():
        want = jax_wait_propagate(own, all_in, dl, death=death,
                                  use_pallas=False)
        pallas = wait_pallas(own, all_in, dl, death, interpret=True)
    ts = [_torch_of(x, dtype) for x in (own, all_in, dl, death)]
    for port in (wait_ref(*ts[:3], ts[3]),
                 wait_propagate(*ts[:3], death=ts[3])):
        for j in range(2):
            got = _port_bits(port[j], bits)
            for ref in (want[j], pallas[j]):
                _same_ieee(got, ref, bits)
        s = _np_wait(own, all_in, dl, bits)
        np.testing.assert_array_equal(_port_bits(port[0], bits),
                                      s.view(bits))


# ---------------------------------------------------------------------------
# A numpy model of the wait kernel's launch (csrc/sweep.cu): the plan's
# blocks, threads, vectors and tail, each element written exactly once
# on every route, and every index a thread computes within one block of
# the end (offsets are 64-bit).
# ---------------------------------------------------------------------------

from repro_torch.kernels.sweep.sweep import WaitPlan, wait_plan  # noqa: E402

_WAIT_TOTALS = ([32 * L for L in (1, 308, 3837, 24120, 51529, 19690, 515)]
                + [1, 7, 3_000_001])


def _wait_threads(plan):
    """Each thread's vector index ``j``, in block order."""
    return (np.arange(plan.grid)[:, None] * plan.threads
            + np.arange(plan.threads)[None, :]).ravel()


def _model_wait_writes(total, plan):
    """How often the planned launch writes each of ``total`` elements."""
    vec = plan.vec
    units = total // vec
    j = _wait_threads(plan)
    elems = (j[j < units][:, None] * vec + np.arange(vec)[None, :]).ravel()
    if vec > 1:                               # block 0's tail
        tail = units * vec + np.arange(plan.threads)
        elems = np.concatenate([elems, tail[tail < total]])
    return np.bincount(elems, minlength=total)


def _wait_reach(total, plan):
    """The largest index any thread computes: its vector's last element,
    the tail's element."""
    units = total // plan.vec
    return max(plan.grid * plan.threads * plan.vec - 1,
               units * plan.vec + plan.threads - 1)


def _wait_plans(total):
    """Every plan the wrapper makes for ``total`` elements: each element
    size, operand count, alignment and route request it can plan."""
    return {tuple(wait_plan(total, size, ops, aligned=aligned,
                            vector=vector))
            for size in (8, 4, 2) for ops in (3, 4)
            for aligned in (True, False)
            for vector in ((None, True, False) if aligned else (None, False))}


@pytest.mark.parametrize("total", _WAIT_TOTALS + ["vector-1", "vector",
                                                  "vector+1"])
def test_wait_launch_model_writes_each_element_once(total):
    """Every plan of the path's level sizes, of 1 and 7 elements, one
    16-byte vector and one off, and of 3,000,001 elements writes each
    element once, over as few blocks as cover the level, on the vector
    route (aligned) and the scalar route (a small level, or a view one
    element in)."""
    sizes = [total] if isinstance(total, int) else [
        16 // s + {"vector-1": -1, "vector": 0, "vector+1": 1}[total]
        for s in (8, 4, 2)]
    for n in sizes:
        routes = set()
        for p in _wait_plans(n):
            plan = WaitPlan(*p)
            assert plan.grid == max(-(-(n // plan.vec) // plan.threads), 1)
            w = _model_wait_writes(n, plan)
            assert w.min() == 1 and w.max() == 1, (n, plan)
            routes.add(plan.vec > 1)
        assert routes == {True, False}
    assert wait_plan(3_000_001, 8) == (2, 256, 5860)


def test_wait_plan_offsets_and_edges():
    """Offsets are 64-bit (the source's ``WaitOffset``), and every index
    a thread computes stays within one block of the end, also past 2**31
    elements; the grid's edge; the plan at the path's widest level; what
    cannot be planned raises."""
    assert re.search(r"using WaitOffset = long long;", _SRC)
    for total in (2 ** 31 - 1, 2 ** 31, 2 ** 33 + 5):
        for p in _wait_plans(total):
            plan = WaitPlan(*p)
            assert (_wait_reach(total, plan)
                    < total + plan.threads * plan.vec < 2 ** 63), plan
    # one element a thread: the most blocks a grid takes, then too many
    top = 2 ** 31 * 256
    assert wait_plan(top - 256, 8, aligned=False).grid == 2 ** 31 - 1
    with pytest.raises(ValueError, match="grid"):
        wait_plan(top - 255, 8, aligned=False)
    # the path's widest level: the vector route, but for the f64 churn
    # variant, whose four 8-byte scalar loads a thread reach
    # WAIT_SCALAR_LOAD_BYTES
    assert wait_plan(32 * 51529, 8) == (2, 256, 3221)
    assert wait_plan(32 * 51529, 2) == (8, 256, 806)
    assert wait_plan(32 * 51529, 8, 4) == (1, 256, 6442)
    assert wait_plan(32 * 51529, 8, 4, vector=True).vec == 2
    assert wait_plan(32 * 51529, 4, 4).vec == 4
    assert wait_plan(32 * 51529, 2, 4).vec == 8
    assert wait_plan(32 * 51529, 8, aligned=False).vec == 1
    # a small level takes one element a thread, over as few blocks
    assert wait_plan(32 * 308, 2) == (1, 256, 39)
    assert wait_plan(32, 8) == (1, 256, 1)
    assert wait_plan(32, 2, vector=True) == (8, 256, 1)
    min_bytes = _wrapper.WAIT_VEC_MIN_BYTES
    assert wait_plan(min_bytes // 4, 4).vec == 4
    assert wait_plan(min_bytes // 4 - 1, 4).vec == 1
    for bad in ((0, 8), (5, 3), (100, 8, 2), (100, 8, 5)):
        with pytest.raises(ValueError):
            wait_plan(*bad)
    with pytest.raises(ValueError, match="aligned"):
        wait_plan(100, 8, aligned=False, vector=True)


def test_wait_plan_matches_launcher_source():
    """The wrapper's wait constants are the kernel's, its plan fields are
    the source's WaitPlan, the launchers take the wrapper's argument
    lists and refuse another plan, and the profiler's kernel names
    (``wait_kernel``, ``wait_churn_kernel``) are there."""
    for name in ("WAIT_THREADS", "WAIT_VEC_MIN_BYTES",
                 "WAIT_SCALAR_LOAD_BYTES"):
        assert _CONST[name] == getattr(_wrapper, name), name
    fields = re.search(r"struct WaitPlan \{\s*long long ([^;]*);",
                       _SRC).group(1)
    assert [f.strip() for f in fields.split(",")] == list(WaitPlan._fields)
    assert "p.vec != vec || p.grid != grid" in _SRC
    body = re.search(r"#define REPRO_WAIT_LAUNCHERS\(SUFFIX, T\)(.*?)"
                     r"\n\n", _SRC, re.S).group(1)
    heads = re.findall(r"_##SUFFIX\((.*?)\)", body, re.S)
    assert [h.count(",") + 1 for h in heads] == [
        len(_wrapper._WAIT_ARGTYPES), len(_wrapper._WAIT_CHURN_ARGTYPES)]
    assert {"wait_kernel(", "wait_churn_kernel("} <= set(
        re.findall(r"\b(wait\w*_kernel\()", _SRC))
