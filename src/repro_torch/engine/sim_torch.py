"""The FD forward and merge-and-backward sweep, and the CN / CN* arrival
sweep, on a torch device.

The port of the reference package's jitted sweeps
(``repro/engine/sim_jax.py``: ``_fd_sweep_impl``, ``_cn_sweep``,
``_fold_lists``, ``_retire``, ``_fold_max``, ``_device_slices``,
``run_entries_jax``), with and without churn, in eager PyTorch:

  * the per-depth forward flood — query arrival times down the BFS tree
    (the ``arrivals`` kernel) plus the Strategy-1 "who-sent-first" edge
    reduction;
  * the bottom-up k-list merge — the plan's static fold schedule
    (:class:`~repro_torch.engine.plan.DepthSlices`) executes only real
    pairwise merges, each one a call of the ``merge`` kernel, and each
    level's send times come from the ``wait`` kernel (Appendix A);
  * churn (finite ``lifetime_mean_s``, §4): a peer dead at its send
    time gets ``send = inf`` (the wait kernel's churn variant) and -inf
    / -1 merged rows; under ``fd-dynamic`` the §4.2 dead-parent reroute
    folds each level's static grandchild table (``DepthSlices.rr_*``),
    a grandchild slot being live iff its parent died — masks over fixed
    shapes;
  * CN / CN*: only the forward flood (the ``arrivals`` kernel) plus each
    peer's execution time; the baselines' arithmetic is the shared numpy
    ``_cn_entries``.

On a CUDA device every one of those calls launches a hand-written CUDA
kernel (``repro_torch.kernels``); on the CPU the same calls run the
kernels' plain PyTorch versions.  Gathers, concatenations, the max-fold
of child arrivals and the Strategy-1 count stay plain tensor code, as
they were plain XLA in the reference.

Everything stochastic is precomputed in numpy by the shared
``_precompute_draws`` (the reference's RNG streams, in its order), and
the urgent-list / reroute-count / retrieval epilogue is the shared
numpy code, so in float64 this sweep gives the reference's bits in every
RNG mode.  The merge follows ``merge_ref``'s tie rule (list ``a`` first,
then the lower position) everywhere; on distinct scores — what f64
uniform draws give — every merge rule selects the same lists.

Reduced precision (``precision="f32"`` / ``"bf16"``) narrows every
draw the sweeps read once on the host (``engine.precision.host_cast``)
and uploads it in that dtype; the sweeps then run end to end in it
through the same kernels, and every float operand of a sweep must share
that one dtype (a float64 operand would silently promote the op).  The
level outputs come back widened to float64 (exact) for the shared numpy
epilogue, whose ground-truth top-k is rebuilt from the cast scores, as
the reference's ``run_entries_jax`` does.  Its urgent post-pass sums a
child's arrival in the run's dtype, as the sweep did, so each list is
on time or late once; ``run_entries_jax`` sums it again in float64 and
can merge a list and send it urgent both.

Entry rows are independent and PyTorch runs eagerly, so there is no
power-of-two padding of entry groups (the reference pads only to bound
its jit cache).

Entry sharding (``shard_devices``, the reference's
``_sharded_fd_sweep``): each origin group's FD entries are split into
contiguous chunks, one per device; each chunk's draws go to its device,
whose cached static tables its sweep reads, and the level outputs come
back into the same host rows.  Rows are independent, so the result is
the unsharded one, bit for bit.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.engine.plan import DepthSlices, NetworkPlan
from repro_torch.engine.precision import host_cast
from repro_torch.kernels.merge.ops import merge_scorelists
from repro_torch.kernels.sweep.ops import level_arrivals, wait_propagate
from repro_torch.p2psim.metrics import ENTRY_BYTES_PAPER
from repro_torch.p2psim.simulate import (SimParams, _accept_urgent_origin,
                                         _cn_entries, _empty_out,
                                         _entry_latencies,
                                         _precompute_draws,
                                         _reroute_counts,
                                         _retrieval_exact,
                                         _retrieval_shared,
                                         _true_topk_by_origin, wait_time)

NEG_INF = float("-inf")


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _retire(pools, ret, ret_perm, valid=None):
    """Gather each finished segment's slot, in parent-ascending order.

    ``valid``: slot mask over the ROUND-0 pool.  Only round-0
    retirements (single-slot segments) can surface a never-merged input
    slot, so that is the only place the mask applies — every later
    retirement is a merge output, already mask-resolved.
    """
    parts = []
    for r, idx in enumerate(ret):
        if idx is None:
            continue
        seg = pools[r][:, idx]
        if valid is not None and r == 0:
            m = valid[:, idx]
            seg = torch.where(m[..., None] if seg.dim() == 3 else m,
                              seg, NEG_INF)
        parts.append(seg)
    return torch.cat(parts, dim=1)[:, ret_perm]


def _fold_lists(cv, co, sched, valid=None):
    """Run the static fold schedule ``sched = (rounds, ret, ret_perm)``
    over the child k-lists; returns each parent's merged top-k, in
    parent-ascending order.

    ``valid``: per-slot on-time mask over round 0's slots.  It is
    THREADED through the fold — merge inputs mask in the kernel, merge
    outputs are always valid, carried slots inherit — so no masked copy
    of the full child array is ever materialized.
    """
    rounds, ret, ret_perm = sched
    pools_v, pools_o = [cv], [co]
    vm = valid
    for mi_a, mi_b, pi in rounds:
        ma = mb = None
        if vm is not None:
            ma, mb = vm[:, mi_a], vm[:, mi_b]
        mv, mo = merge_scorelists(cv[:, mi_a], co[:, mi_a],
                                  cv[:, mi_b], co[:, mi_b],
                                  valid_a=ma, valid_b=mb)
        if pi.shape[0]:
            mv = torch.cat([mv, cv[:, pi]], dim=1)
            mo = torch.cat([mo, co[:, pi]], dim=1)
            if vm is not None:
                vm = torch.cat(
                    [torch.ones((mv.shape[0], mi_a.shape[0]),
                                dtype=torch.bool, device=mv.device),
                     vm[:, pi]], dim=1)
        elif vm is not None:
            vm = torch.ones(mv.shape[:2], dtype=torch.bool,
                            device=mv.device)
        cv, co = mv, mo
        pools_v.append(mv)
        pools_o.append(mo)
    return (_retire(pools_v, ret, ret_perm, valid),
            _retire(pools_o, ret, ret_perm))


def _fold_max(a, lv):
    """Child-slot schedule, max-reduce: each parent's latest child
    arrival."""
    pools = [a]
    for mi_a, mi_b, pi in lv["rounds"]:
        ma = torch.maximum(a[:, mi_a], a[:, mi_b])
        if pi.shape[0]:
            ma = torch.cat([ma, a[:, pi]], dim=1)
        a = ma
        pools.append(ma)
    return _retire(pools, lv["ret"], lv["ret_perm"])


def _arrivals(dn_term, levels, E, dt, dev):
    """Per-level query arrival times down the tree: level d's from level
    d-1's through the ``arrivals`` kernel (the forward flood)."""
    t_qs = [torch.zeros((E, 1), dtype=dt, device=dev)]
    for d in range(1, len(levels)):
        lv = levels[d]
        t_qs.append(level_arrivals(t_qs[d - 1], dn_term[:, lv["vv"]],
                                   lv["par_pos"]))
    return t_qs


def _one_dtype(*ts):
    """The one float dtype of the sweep operands ``ts`` (None entries
    skipped); raises when they differ."""
    dts = {t.dtype for t in ts if t is not None}
    if len(dts) != 1:
        raise TypeError("sweep operands mix float dtypes "
                        f"{sorted(map(str, dts))}")
    return dts.pop()


def _fd_sweep(scores, t_exec, up_term, dn_term, wt, tqf, lam, levels,
              els, *, k: int, with_st1: bool, death=None, rr=None):
    """Forward + merge-and-backward sweeps of one origin's tree.

    Per-level functional form: level d's tensors are produced from level
    d±1's by static gathers — nothing is scattered into a global buffer.
    Bit-parity contract (f64): every float expression groups exactly as
    the reference sweep's; k-lists are padded to K = 2^ceil(log2 k) with
    -inf tails that never surface in the top k.

    Churn (``death`` given, (E, n) death times): a peer dead at its raw
    send time ``s`` gets ``send = inf`` (its arrival can never release a
    waiting parent) and -inf / -1 merged rows.  ``rr`` (the per-level
    reroute tables, churn only) additionally folds each level's static
    grandchild slots: a grandchild's list reaches its grandparent iff
    its parent died (its own death is already in its -inf rows).

    Every float operand shares one dtype (f64, f32 or bf16), and so does
    every intermediate: buffers are made in it and Python scalars keep
    it.

    Returns per-level send times, merged values (E, L, k) and owners,
    the Strategy-1 skip count per entry (None for FD-Basic), and the
    per-level liveness masks (None without churn).
    """
    E = t_exec.shape[0]
    dt = _one_dtype(scores, t_exec, up_term, dn_term, wt, tqf, lam, death)
    dev = t_exec.device
    K = _next_pow2(k)
    dmax = len(levels) - 1
    with_churn = death is not None

    skip = None
    if with_st1:
        els_src, els_dst, cond = els
        send_at = tqf[None, :] + lam
        skip = ((send_at[:, els_dst] < send_at[:, els_src])
                & cond[None, :]).sum(dim=1)

    t_qs = _arrivals(dn_term, levels, E, dt, dev)

    send = [None] * (dmax + 1)
    m_v = [None] * (dmax + 1)
    m_o = [None] * (dmax + 1)
    alive = [None] * (dmax + 1)
    for d in range(dmax, -1, -1):
        lv = levels[d]
        vv = lv["vv"]
        L = vv.shape[0]
        own_ready = t_qs[d] + t_exec[:, vv]
        deadline = t_qs[d] + wt[vv][None, :]
        own_v = scores[:, vv]
        if K > k:
            own_v = torch.cat(
                [own_v, torch.full((E, L, K - k), NEG_INF, dtype=dt,
                                   device=dev)], dim=2)
        own_o = vv.to(torch.int32)[None, :, None].expand(E, L, K)
        a0 = None
        if "cnode" not in lv:                    # all leaves
            all_in = torch.zeros((E, L), dtype=dt, device=dev)
        else:
            # a dead child's send is inf, so its parent waits until its
            # deadline and the child is never on time: no extra mask
            a0 = send[d + 1][:, lv["c_in_next"]] + up_term[:, lv["cnode"]]
            # the parent's send time depends on all_in, a pure max over
            # ALL child arrivals
            n_par = lv["ret_perm"].shape[0]
            am = _fold_max(a0, lv)
            all_in = torch.cat(
                [am, torch.zeros((E, L - n_par), dtype=dt, device=dev)],
                dim=1)[:, lv["asm_perm"]]
        if with_churn:
            death_lv = death[:, vv]
            s, snd = wait_propagate(own_ready, all_in, deadline,
                                    death=death_lv)
        else:
            s = snd = wait_propagate(own_ready, all_in, deadline)
        if a0 is None:
            mv, mo = own_v, own_o
        else:
            # on-time = arrived by the parent's (raw) send time
            ont = a0 <= s[:, lv["cpar_pos"]]
            cv0 = m_v[d + 1][:, lv["c_in_next"]]
            co0 = m_o[d + 1][:, lv["c_in_next"]]
            vmask = ont
            sched = (lv["rounds"], lv["ret"], lv["ret_perm"])
            if rr is not None and rr[d] is not None:
                r = rr[d]
                cv0 = torch.cat([cv0, m_v[d + 2][:, r["gc_pos"]]], dim=1)
                co0 = torch.cat([co0, m_o[d + 2][:, r["gc_pos"]]], dim=1)
                vmask = torch.cat(
                    [ont, ~alive[d + 1][:, r["gc_par_pos"]]], dim=1)
                sched = (r["rounds"], r["ret"], r["ret_perm"])
            child_v, child_o = _fold_lists(cv0, co0, sched, valid=vmask)
            pv, po = merge_scorelists(own_v[:, lv["par_sel"]],
                                      own_o[:, lv["par_sel"]],
                                      child_v, child_o)
            mv = torch.cat(
                [pv, own_v[:, lv["leaf_sel"]]], dim=1)[:, lv["asm_perm"]]
            mo = torch.cat(
                [po, own_o[:, lv["leaf_sel"]]], dim=1)[:, lv["asm_perm"]]
        send[d] = snd
        if with_churn:
            alv = death_lv >= s
            alive[d] = alv
            mv = torch.where(alv[..., None], mv, NEG_INF)
            mo = torch.where(alv[..., None], mo, -1)
        m_v[d], m_o[d] = mv, mo
    return (send, [v[:, :, :k] for v in m_v], [o[:, :, :k] for o in m_o],
            skip, alive if with_churn else None)


def _cn_sweep(t_exec, dn_term, levels):
    """CN / CN* need only the arrival sweep: each level's execution-done
    times ``t_q + t_exec``."""
    t_qs = _arrivals(dn_term, levels, t_exec.shape[0],
                     _one_dtype(t_exec, dn_term), t_exec.device)
    return [tq + t_exec[:, lv["vv"]] for tq, lv in zip(t_qs, levels)]


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, dtype kept (int32 plan
    indices stay int32)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _upload(a: np.ndarray, precision: str, device) -> torch.Tensor:
    """A float64 host array cast to ``precision`` on the host, then put
    on ``device`` in that dtype."""
    return host_cast(a, precision).to(device)


def _entry_rows(t: torch.Tensor, es: np.ndarray, device) -> torch.Tensor:
    """Rows ``es`` of a per-entry (E, ...) host tensor, already in the
    run's dtype, put on ``device``; when ``es`` is the whole batch (then
    ``es == arange(E)``) no gather."""
    return (t if len(es) == t.shape[0] else t[torch.from_numpy(es)]).to(
        device)


def _host(t: torch.Tensor) -> np.ndarray:
    """A level output as a host array; floats widened to float64
    (exact) for the shared numpy epilogue."""
    t = t.cpu()
    return (t.to(torch.float64) if t.is_floating_point() else t).numpy()


def _conv_slice_field(f, v, device):
    if f.endswith("rounds"):
        return tuple(tuple(_to_device(x, device) for x in rnd)
                     for rnd in v)
    if f.endswith("ret"):
        return tuple(None if idx is None else _to_device(idx, device)
                     for idx in v)
    return _to_device(v, device)


_RR_FIELDS = ("rr_gc_pos", "rr_gc_par_pos", "rr_rounds", "rr_ret",
              "rr_ret_perm")


def _device_slices(sl: DepthSlices, device: torch.device):
    """``sl``'s level tables, Strategy-1 edge arrays and (once the plan
    carries them) reroute tables as tensors on ``device``, cached on the
    instance per device (one upload per plan and device).

    Returns ``(levels, els, rr)``; ``rr`` is None until ``sl`` has been
    extended with reroute tables, else one dict per level (None where a
    level has no grandchildren).  The reroute tables are cached
    SEPARATELY from the static tables, so a plan that later serves churn
    keeps the static sweep's tensors as they were.  A live overlay's
    ``NetworkPlan.sync`` drops both caches of an instance it keeps
    (``DepthSlices.refresh`` deletes ``_device`` and ``_device_rr``), so
    the next call uploads the re-derived edge arrays.
    """
    cache = sl.__dict__.setdefault("_device", {})
    key = str(device)
    if key not in cache:
        levels = tuple({f: _conv_slice_field(f, v, device)
                        for f, v in lv.items() if not f.startswith("rr_")}
                       for lv in sl.levels)
        els = (_to_device(sl.els_src, device),
               _to_device(sl.els_dst, device),
               _to_device(sl.cond, device))
        cache[key] = (levels, els)
    rr_cache = sl.__dict__.setdefault("_device_rr", {})
    if key not in rr_cache and sl.reroute:
        rr_cache[key] = tuple(
            {f[3:]: _conv_slice_field(f, lv[f], device) for f in _RR_FIELDS}
            if "rr_rounds" in lv else None
            for lv in sl.levels)
    return cache[key] + (rr_cache.get(key),)


def _slices(plan: NetworkPlan, st, device, reroute: bool, out: dict):
    """The plan's depth slices of ``st`` on ``device``; the wall time of
    whatever this call had to build or upload (the slices, their reroute
    extension, either upload) is added to ``out["compile_s"]``."""
    t0 = time.perf_counter()
    n_slices = len(plan._slices)
    sl = plan.depth_slices(st)
    key = str(device)
    fresh = (len(plan._slices) > n_slices
             or (reroute and not sl.reroute)
             or key not in sl.__dict__.get("_device", {})
             or (reroute and key not in sl.__dict__.get("_device_rr", {})))
    if reroute:
        plan.depth_slices(st, reroute=True)
    levels, els, rr = _device_slices(sl, device)
    if fresh:
        out["compile_s"] += time.perf_counter() - t0
    return sl, levels, els, rr


def shard_devices(device: torch.device, shard: bool,
                  devices=None) -> Optional[Tuple[torch.device, ...]]:
    """The devices an FD sweep's entries are split over, or None for one
    sweep on ``device``.

    ``shard=True`` on a CUDA device takes every local CUDA device, and
    with one device it is ignored (None), as in the reference.  A given
    ``devices`` list (repeats allowed) forces that split, on any device
    type; without one ``shard=True`` is refused on the CPU, which has
    no devices to split over.
    """
    if not shard:
        return None
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("shard devices must not be empty")
        return devs
    if device.type != "cuda":
        raise ValueError(
            f"shard=True splits the entries over the local CUDA devices; "
            f"there are none on {device}")
    n_dev = torch.cuda.device_count()
    if n_dev == 1:
        return None
    return tuple(torch.device("cuda", i) for i in range(n_dev))


def _on(device: torch.device):
    """The context a chunk's launches run in: its CUDA device made
    current (the kernels launch on the current device's stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def run_entries_torch(plan: NetworkPlan, sts, ent_st: np.ndarray,
                      ent_origin: np.ndarray, seeds, n: int, p: SimParams,
                      algorithm: str, dynamic: bool, lifetime_mean_s: float,
                      independent: bool, device: torch.device,
                      replicas=None, precision: str = "f64",
                      shard: Optional[Sequence[torch.device]] = None
                      ) -> dict:
    """FD (with or without churn) or CN / CN* over a flattened (E,) entry
    batch on ``device``.

    The counterpart of the reference's ``run_entries_jax``: the same
    per-entry output dict (metric arrays, the origin's merged
    ``values`` / ``owners``), plus ``compile_s`` — the wall time of the
    depth-slice compiles, reroute extensions and uploads this call had
    to do (0.0 on a warm plan).  ``precision="f32"`` / ``"bf16"`` runs
    the sweeps in that dtype on draws cast once on the host (tolerance
    contract); ``"f64"`` gives the reference's bits.

    ``shard`` (from :func:`shard_devices`): the devices each origin
    group's FD entries are split over, in contiguous chunks; all
    chunks are launched before any output is read back, so the devices
    sweep at once.  CN / CN* always run on ``device``.
    """
    churn = not math.isinf(lifetime_mean_s)
    E = len(seeds)
    S = len(sts)
    k = p.k
    list_bytes = k * ENTRY_BYTES_PAPER
    ent_of_st = [np.flatnonzero(ent_st == s) for s in range(S)]
    par_lat, origin_lat = _entry_latencies(sts, ent_st, p)
    draws = _precompute_draws(ent_origin, seeds, n, p, algorithm,
                              sts[0].fw_strategy, lifetime_mean_s,
                              independent, par_lat, origin_lat)
    out = _empty_out(E, k)
    out["compile_s"] = 0.0
    cast: dict = {}

    def _lo(name):
        """A per-entry draw narrowed to the run's dtype, once a run."""
        if name not in cast:
            cast[name] = host_cast(getattr(draws, name), precision)
        return cast[name]

    # ---- CN / CN*: arrival sweep on the device, baseline math shared ----
    if algorithm in ("cn", "cn_star"):
        out["m_fw"][:] = np.array([st.m_basic for st in sts],
                                  np.int64)[ent_st]
        t_ex_done = np.full((E, n), np.inf)
        for si, st in enumerate(sts):
            es = ent_of_st[si]
            sl, levels, _, _ = _slices(plan, st, device, False, out)
            ted = _cn_sweep(_entry_rows(_lo("t_exec"), es, device),
                            _entry_rows(_lo("dn_term"), es, device), levels)
            for d, lv in enumerate(sl.levels):
                t_ex_done[np.ix_(es, lv["vv"])] = _host(ted[d])
        _cn_entries(out, draws, sts, ent_st, ent_origin, t_ex_done, p,
                    algorithm)
        return out

    # ---- FD: forward + merge sweeps per origin --------------------------
    with_reroute = churn and dynamic
    send_t = np.full((E, n), np.inf)
    mvals = np.empty((E, n, k))
    mown = np.full((E, n, k), -1, np.int32)
    valid = np.zeros((E, n), bool) if churn else None
    for si, st in enumerate(sts):
        es_all = ent_of_st[si]
        with_st1 = st.fw_strategy != "basic"
        wt = wait_time(st.ttl_rem, p)
        tqf_h = (np.where(st.depth >= 0, st.depth * p.t_qsnd_s, np.inf)
                 if with_st1 else None)
        chunks = ([(device, es_all)] if shard is None else
                  [(dv, c) for dv, c in zip(
                      shard, np.array_split(es_all, len(shard))) if len(c)])
        swept = []
        for dv, es in chunks:

            def _take(name):
                return _entry_rows(_lo(name), es, dv)

            with _on(dv):
                sl, levels, els, rr = _slices(plan, st, dv, with_reroute,
                                              out)
                tqf = lam = None
                if with_st1:
                    tqf = _upload(tqf_h, precision, dv)
                    lam = _take("lam")
                swept.append((es, _fd_sweep(
                    _take("scores"), _take("t_exec"), _take("up_term"),
                    _take("dn_term"), _upload(wt, precision, dv), tqf, lam,
                    levels, els, k=k, with_st1=with_st1,
                    death=_take("death") if churn else None,
                    rr=rr if with_reroute else None)))
        for es, (send_d, mv_d, mo_d, skip, alive_d) in swept:
            for d, lv in enumerate(sl.levels):
                rows = np.ix_(es, lv["vv"])
                send_t[rows] = _host(send_d[d])
                mvals[rows] = _host(mv_d[d])
                mown[rows] = _host(mo_d[d])
                if churn:
                    valid[rows] = _host(alive_d[d])
            out["m_fw"][es] = (st.fw_static + sl.n_els
                               - skip.cpu().numpy().astype(np.int64)
                               if with_st1 else st.m_basic)

    # every reached peer that is still alive at its send time sends its
    # list exactly once (without churn that is everyone but the origin)
    if churn:
        for si, st in enumerate(sts):
            es = ent_of_st[si]
            n_alive = valid[np.ix_(es, st.idx)].sum(axis=1)
            out["m_bw"][es] += n_alive - 1        # origin never dies
            out["b_bw"][es] += (n_alive - 1) * list_bytes
    else:
        n_reached_arr = np.array([len(st.idx) for st in sts], np.int64)
        out["m_bw"] += n_reached_arr[ent_st] - 1
        out["b_bw"] += (n_reached_arr[ent_st] - 1) * list_bytes

    # ---- urgent lists (§4.1): late-arrival post-pass --------------------
    urgent: list = [[] for _ in range(E)]
    if dynamic:
        hop_term = p.latency_mean_s + list_bytes / p.bw_mean_Bps
        for si, st in enumerate(sts):
            es = ent_of_st[si]
            ch = st.kid_sorted
            if len(ch) == 0:
                continue
            pr = st.parent[ch]
            # the sweep's own sum in its dtype (widened exactly), so a
            # list is either on time at its parent or late, never both
            rows = np.ix_(es, ch)
            a = (host_cast(send_t[rows], precision)
                 + _lo("up_term")[tuple(map(torch.from_numpy, rows))]
                 ).double().numpy()
            late = a > send_t[np.ix_(es, pr)]
            if churn:
                # a dead child never went urgent; a dead parent's
                # children reroute (counted below) instead
                late &= valid[np.ix_(es, ch)] & valid[np.ix_(es, pr)]
            if not late.any():
                continue
            d_par = st.depth[pr]
            ei, ci = np.nonzero(late)
            etas = a[ei, ci] + d_par[ci] * hop_term
            for e_, c_, eta in zip(es[ei], ch[ci], etas):
                urgent[int(e_)].append((eta, int(c_)))
            out["m_bw"][es] += (late * d_par[None, :]).sum(axis=1)
            out["b_bw"][es] += (late
                                * (d_par[None, :] * list_bytes)).sum(axis=1)

    # ---- §4.2 reroute accounting: one message per accepted list ---------
    if with_reroute:
        for si, st in enumerate(sts):
            es = ent_of_st[si]
            cnt = _reroute_counts(st, valid[es])
            out["m_bw"][es] += cnt
            out["b_bw"][es] += cnt * list_bytes

    # ground truth from the scores as the sweep saw them (widened
    # exactly): in f64 the very array the sweep read
    truth_scores = _lo("scores").double().numpy()
    top_true_all = _true_topk_by_origin(truth_scores, sts, ent_of_st, k)
    t_merge_done = send_t[np.arange(E), ent_origin] + p.merge_s
    _accept_urgent_origin(urgent, ent_origin, t_merge_done, mvals, mown,
                          valid, k)
    ar = np.arange(E)
    out["values"] = mvals[ar, ent_origin]
    out["owners"] = mown[ar, ent_origin].astype(np.int64)
    if draws.exact:
        _retrieval_exact(out, draws, ent_origin, t_merge_done, mvals,
                         mown, top_true_all, p, replicas)
    else:
        _retrieval_shared(out, draws, ent_origin, t_merge_done, mvals,
                          mown, top_true_all, p, replicas)
    return out
