"""SimEngine — the unified engine over the overlay simulator, with the
FD sweep on a torch device.

``prepare(topology)`` compiles a :class:`~repro_torch.engine.plan.
NetworkPlan` once; every subsequent ``run(spec, policy)`` reuses the
cached CSR, directed edges, per-origin BFS trees / forward masks,
auto-TTLs and device-resident depth slices.

This package carries ``fd-basic``, ``fd-st1``, ``fd-st1+2`` and
``fd-dynamic`` with or without churn (finite ``lifetime_mean_s``; §4.2
dead-parent rerouting under ``fd-dynamic``) and the ``cn`` / ``cn-star``
baselines, with i.i.d. or per-edge (``latency_model="edge"``, any
coordinate-carrying topology of ``repro_torch.p2psim.topologies``) link
latencies.  In float64 and every RNG mode its ``TopKResult`` carries
the reference package's bits (``values``, ``indices`` and every
``BatchMetrics`` field); ``precision="f32"`` / ``"bf16"`` runs the
sweep in that dtype under the tolerance contract of
:mod:`repro_torch.engine.precision`.

The two-round ``fd-stats`` heuristic (paper §3.3) runs the scalar
reference twice on the host, as the reference package does in both of
its backends: its result says so (``backend_used == "sim"``), and the
engine warns once.  Nothing else falls back to another path.

``prepare`` (or the constructor) also takes a live
:class:`~repro_torch.p2psim.overlay.Overlay`: the engine's plan is then
bound to it and re-synced incrementally before every execution
(``NetworkPlan.sync``), so peers may join and leave between queries and
every answer equals, bit for bit, the answer from a plan rebuilt from
scratch on the mutated overlay.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.mesh import resolve_device
from repro_torch.engine.api import (PRECISIONS, Engine, Policy, QuerySpec,
                                    TopKResult)
from repro_torch.engine.plan import NetworkPlan
from repro_torch.engine.precision import check_tolerance
from repro_torch.engine.sim_torch import run_entries_torch, shard_devices
from repro_torch.kernels import _build
from repro_torch.p2psim.graph import Topology
from repro_torch.p2psim.metrics import QUERY_BYTES, BatchMetrics, QueryMetrics
from repro_torch.p2psim.overlay import Overlay
from repro_torch.p2psim.simulate import (SimParams, _latency_mode,
                                         run_query_reference)

_BM_FIELDS = ("m_bw", "m_rt", "b_bw", "b_rt", "response_time_s", "accuracy")
_ALL_BM_FIELDS = ("n_reached", "n_edges_pq", "avg_degree", "m_fw",
                  "b_fw") + _BM_FIELDS


def _batch_of_one(met: QueryMetrics) -> BatchMetrics:
    """Wrap one scalar QueryMetrics as a (1, 1) BatchMetrics."""
    bm = BatchMetrics.empty(met.algorithm, 1, 1)
    for f in _ALL_BM_FIELDS:
        getattr(bm, f)[0, 0] = getattr(met, f)
    return bm


def _slice_rows(bm: BatchMetrics, lo: int, n_queries: int,
                n_trials: int) -> BatchMetrics:
    """Reshape rows [lo, lo + Q*T) of a flat (N, 1) batch to (Q, T)."""
    out = BatchMetrics.empty(bm.algorithm, n_queries, n_trials)
    hi = lo + n_queries * n_trials
    for f in _ALL_BM_FIELDS:
        getattr(out, f)[:] = getattr(bm, f)[lo:hi, 0].reshape(
            n_queries, n_trials)
    return out


class SimEngine(Engine):
    """Unified Top-k engine over the overlay simulator, sweep on a torch
    device.

    ``device``: where the sweep runs — ``"cuda"`` by default (the
    hand-written kernels of ``repro_torch.kernels``), ``"cpu"`` for the
    kernels' plain PyTorch versions.  ``device=None`` without a CUDA
    device raises.  The first CUDA execution builds the kernel library;
    that time is booked in ``TopKResult.compile_s``.

    ``precision``: ``"f64"`` (default — the reference's bits), ``"f32"``
    or ``"bf16"`` (the sweep runs in that dtype; tolerance contract).  A
    spec's ``precision`` overrides it per request.  With
    ``validate_precision=True`` (default) a reduced-precision execution
    also reruns the same entries in f64 on the same device and records
    ``check_tolerance(...).summary()`` in ``extras["tolerance"]``;
    timed paths switch it off.

    ``shard``: split each origin group's FD entries over every local
    CUDA device in contiguous chunks, each swept on its own device
    (how a batch too large for one card's memory still runs), with the
    unsharded bits in every dtype; the f64 rerun of a validated run is
    split too.  With one CUDA device it is ignored, as in the
    reference; CN / CN* are never split.  On the CPU it is refused
    unless ``_shard_devices`` (a device list, repeats allowed) forces
    the chunks, which is how the tests split on one host.
    """

    backend = "sim-torch"

    def __init__(self,
                 top: Optional[Union[Topology, Overlay, NetworkPlan]] = None,
                 params: Optional[SimParams] = None, *, device=None,
                 precision: str = "f64", validate_precision: bool = True,
                 shard: bool = False, _shard_devices=None):
        """Build the engine (and compile ``top``'s plan when given)."""
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.device = resolve_device(device, "SimEngine")
        self._shard = shard_devices(self.device, shard, _shard_devices)
        self.params = params if params is not None else SimParams()
        self.plan: Optional[NetworkPlan] = None
        self._precision = precision
        self._validate_precision = validate_precision
        self._warned_host = False
        if top is not None:
            self.prepare(top)

    def _host_path(self, reason: str) -> str:
        """Record a run on the host reference path; warn AT MOST ONCE per
        engine.  Returns the ``backend_used`` it reports."""
        if not self._warned_host:
            self._warned_host = True
            warnings.warn(
                f"SimEngine(sim-torch): {reason}; running on the host "
                "reference path (reported on TopKResult.backend_used)",
                RuntimeWarning, stacklevel=5)
        return "sim"

    def prepare(self, top: Union[Topology, Overlay, NetworkPlan]
                ) -> NetworkPlan:
        """Compile (or adopt) the overlay's NetworkPlan.

        Passing a live :class:`~repro_torch.p2psim.overlay.Overlay`
        binds the plan to it: every subsequent ``run`` / ``run_many``
        re-resolves the plan against the overlay's current version
        (:meth:`NetworkPlan.sync` — incremental, not a recompile), so
        the engine keeps serving while the network churns.  Mutate the
        overlay only while no request is executing on it."""
        if isinstance(top, NetworkPlan):
            self.plan = top
        elif isinstance(top, (Topology, Overlay)):
            self.plan = NetworkPlan(top)
        else:
            raise TypeError(
                f"expected a Topology, Overlay or NetworkPlan, got "
                f"{type(top)!r} (carry an overlay across with "
                "topology_from_arrays)")
        return self.plan

    def run(self, spec: Optional[QuerySpec] = None,
            policy: Union[str, Policy] = "fd-dynamic", *,
            params: Optional[SimParams] = None) -> TopKResult:
        """Execute ``spec`` under ``policy`` on the prepared overlay.

        This is the batch-of-1 case of :meth:`run_many`.
        """
        spec = spec if spec is not None else QuerySpec()
        return self.run_many([spec], [policy], params=params)[0]

    # ---- dynamic batching (run_many) -------------------------------------

    def _effective(self, spec: QuerySpec,
                   params: Optional[SimParams]) -> SimParams:
        """The ``SimParams`` this spec executes under (spec overrides
        applied)."""
        p = params if params is not None else self.params
        if spec.k is not None:
            p = dataclasses.replace(p, k=spec.k)
        if spec.seed is not None:
            p = dataclasses.replace(p, seed=spec.seed)
        if spec.latency_model is not None:
            p = dataclasses.replace(p, latency_model=spec.latency_model)
        return p

    @staticmethod
    def _coalescable(spec: QuerySpec, pol: Policy) -> bool:
        """True when the spec's entries can be fused with other specs'
        onto one sweep without changing a single drawn bit.

        Independent-stream entries (``rng="independent"`` or explicit
        ``seeds``) draw from their own generators, so their results
        depend only on (origin, entry seed, params, policy) — fusing is
        free.  A SHARED-stream spec draws batch-shaped arrays from one
        generator, so its draws depend on the whole batch shape — except
        for a batch of ONE, which is exactly the independent entry with
        that seed.  Multi-entry shared specs therefore execute alone.
        """
        if pol.algorithm == "fd-stats":
            return False
        return spec.independent or (len(spec.origins) * spec.n_trials == 1)

    def _entry_seeds(self, spec: QuerySpec, p: SimParams) -> np.ndarray:
        """Per-entry RNG seeds, flattened — explicit ``seeds`` verbatim,
        else the engine's ``seed + q * n_trials + t`` derivation."""
        Q, T = len(spec.origins), spec.n_trials
        if spec.seeds is not None:
            seeds = np.asarray(spec.seeds, dtype=np.int64)
            if seeds.shape != (Q, T):
                raise ValueError(
                    f"seeds must be ({Q}, {T}), got {seeds.shape}")
            return seeds.reshape(-1)
        return p.seed + np.arange(Q * T, dtype=np.int64)

    def run_many(self, specs: Sequence[QuerySpec],
                 policies: Union[str, Policy,
                                 Sequence[Union[str, Policy]]]
                 = "fd-dynamic", *,
                 params: Optional[SimParams] = None) -> List[TopKResult]:
        """Execute a request batch, coalescing compatible specs.

        Specs sharing an execution signature — same resolved ``Policy``
        and same effective ``(k, latency_model, precision)`` — whose
        entries are independently seeded (see :meth:`_coalescable`) are
        fused onto ONE batched sweep: their (origin, seed) entries
        concatenate into a single flattened spec with explicit per-entry
        seeds.  Every returned result is entry-wise bit-exact with a
        sequential ``run`` of its spec; ``TopKResult.batch_size``
        records how many requests shared the executed sweep.
        """
        pols = self._zip_policies(specs, policies)
        results: List[Optional[TopKResult]] = [None] * len(specs)
        groups: dict = {}               # signature -> [request index]
        for i, (spec, pol) in enumerate(zip(specs, pols)):
            p = self._effective(spec, params)
            if not self._coalescable(spec, pol):
                results[i] = self._execute(spec, pol, p)
                continue
            prec = spec.precision or self._precision
            groups.setdefault((pol, p.k, p.latency_model, prec),
                              []).append(i)
        for (pol, k, lm, prec), idxs in groups.items():
            if len(idxs) == 1:          # nothing to fuse: direct path
                i = idxs[0]
                results[i] = self._execute(
                    specs[i], pol, self._effective(specs[i], params))
                continue
            origins, seeds, shapes = [], [], []
            for i in idxs:
                spec = specs[i]
                p = self._effective(spec, params)
                origins.append(np.repeat(
                    np.asarray(spec.origins, np.int64), spec.n_trials))
                seeds.append(self._entry_seeds(spec, p))
                shapes.append((len(spec.origins), spec.n_trials))
            fused = QuerySpec(
                origins=tuple(int(o) for o in np.concatenate(origins)),
                n_trials=1, k=k, latency_model=lm, precision=prec,
                seeds=np.concatenate(seeds)[:, None])
            res = self._execute(fused, pol,
                                self._effective(fused, params))
            lo = 0
            for i, (Q, T) in zip(idxs, shapes):
                hi = lo + Q * T
                results[i] = dataclasses.replace(
                    res, metrics=_slice_rows(res.metrics, lo, Q, T),
                    values=res.values.reshape(-1, k)[lo:hi]
                    .reshape(Q, T, k),
                    indices=res.indices.reshape(-1, k)[lo:hi]
                    .reshape(Q, T, k),
                    batch_size=len(idxs), extras=dict(res.extras))
                lo += Q * T
        return results

    def _execute(self, spec: QuerySpec, pol: Policy,
                 p: SimParams) -> TopKResult:
        """Run one (already resolved) spec on the prepared overlay."""
        if self.plan is None:
            raise RuntimeError("call SimEngine.prepare(topology) first")
        if self.plan.overlay is not None:
            self.plan.sync()              # live overlay: catch up by version
        _latency_mode(self.plan.top, p)   # validate model name + coords
        prec = spec.precision or self._precision
        if pol.algorithm == "fd-stats":
            if prec != "f64":
                raise ValueError(
                    "fd-stats runs on the scalar reference path, which "
                    "is f64-only; request precision='f64' (or None)")
            return self._run_stats(spec, pol, p)

        origins = np.atleast_1d(np.asarray(spec.origins, dtype=np.int64))
        Q, T = len(origins), spec.n_trials
        ent_seeds = self._entry_seeds(spec, p)
        compile_s = 0.0
        if self.device.type == "cuda":
            compile_s += _build.ensure_built()   # 0.0 once loaded
        baseline = pol.algorithm in ("cn", "cn_star")
        n_statics = len(self.plan._statics)
        t0 = time.perf_counter()
        sts, st_of_q = self.plan.origin_statics(
            origins, p.ttl, "basic" if baseline else pol.strategy)
        # statics wall counts as compile only when this call actually
        # BUILT something — a warm plan reports 0.0
        if len(self.plan._statics) > n_statics:
            compile_s += time.perf_counter() - t0
        ent_st = np.repeat(st_of_q, T)
        ent_origin = np.repeat(origins, T)
        # replica placement is retrieval-phase only (FD paths); the CN
        # baselines never enter the owner-fetch fallback
        rep = None if baseline else self.plan.replica_table(p)
        t0 = time.perf_counter()
        res = run_entries_torch(self.plan, sts, ent_st, ent_origin,
                                ent_seeds, self.plan.top.n, p,
                                pol.algorithm, pol.dynamic,
                                pol.lifetime_mean_s, spec.independent,
                                self.device, replicas=rep, precision=prec,
                                shard=self._shard)
        compile_s += res.pop("compile_s")
        run_s = time.perf_counter() - t0
        vals = res.pop("values")
        owns = res.pop("owners")
        extras: dict = {}
        if prec != "f64" and self._validate_precision:
            # the tolerance contract: rerun the SAME entries in f64 on
            # the same device and measure the reduced result against it
            res64 = run_entries_torch(self.plan, sts, ent_st, ent_origin,
                                      ent_seeds, self.plan.top.n, p,
                                      pol.algorithm, pol.dynamic,
                                      pol.lifetime_mean_s,
                                      spec.independent, self.device,
                                      replicas=rep, precision="f64",
                                      shard=self._shard)
            extras["tolerance"] = check_tolerance(
                prec, vals, owns, res64["values"],
                res64["owners"]).summary()

        bm = BatchMetrics.empty(pol.algorithm, Q, T)
        n_reached_s = np.array([len(st.idx) for st in sts], np.int64)
        n_edges_s = np.array([st.n_edges_pq for st in sts], np.int64)
        avg_deg_s = np.array([st.avg_degree for st in sts])
        bm.n_reached[:] = n_reached_s[st_of_q, None]
        bm.n_edges_pq[:] = n_edges_s[st_of_q, None]
        bm.avg_degree[:] = avg_deg_s[st_of_q, None]
        bm.m_fw[:] = res["m_fw"].reshape(Q, T)
        bm.b_fw[:] = res["m_fw"].reshape(Q, T) * QUERY_BYTES
        for f in _BM_FIELDS:
            getattr(bm, f)[:] = res[f].reshape(Q, T)
        return TopKResult(policy=pol.name, backend=self.backend, k=p.k,
                          backend_used=self.backend,
                          topology=self.plan.top.kind,
                          latency_model=p.latency_model, metrics=bm,
                          precision=prec,
                          values=vals.reshape(Q, T, p.k),
                          indices=owns.reshape(Q, T, p.k),
                          compile_s=compile_s, run_s=run_s, extras=extras)

    # ---- statistics heuristic (paper §3.3 + Fig 7) ----------------------

    def _run_stats(self, spec: QuerySpec, pol: Policy,
                   p: SimParams) -> TopKResult:
        """Two-round protocol: round 1 full FD gathers per-child best-rank
        stats; round 2 forwards Q only to children whose best past score
        ranked above ``z * k`` in the parent's merged list.

        The reference package's ``_run_stats``, copied: both rounds are
        the scalar reference run on the host (``backend_used ==
        "sim"``).  Under a finite ``lifetime_mean_s`` the rounds run
        without churn, as the reference's do."""
        used = self._host_path("the two-round fd-stats heuristic has no "
                               "device sweep")
        t_start = time.perf_counter()
        origins = np.atleast_1d(np.asarray(spec.origins, dtype=np.int64))
        if len(origins) != 1 or spec.n_trials != 1:
            raise ValueError("fd-stats runs one origin x one trial per call")
        if spec.seeds is not None:
            seeds = np.asarray(spec.seeds, dtype=np.int64)
            if seeds.shape != (1, 1):
                raise ValueError(f"seeds must be (1, 1), got {seeds.shape}")
            p = dataclasses.replace(p, seed=int(seeds[0, 0]))
        origin = int(origins[0])
        top = self.plan.top
        if p.ttl == 0:
            # resolve auto-TTL once from the plan cache and thread it
            # through both rounds (round 2 prunes AFTER TTL resolution,
            # so the full-topology eccentricity is the right value twice)
            p = dataclasses.replace(p, ttl=self.plan.auto_ttl(origin))
        met1, st = run_query_reference(top, origin, p, return_state=True)
        children = st["children"]
        ms = st["merged_scores"]
        n = top.n
        keep = np.ones(n, bool)
        k = p.k
        for v in range(n):
            for c in children[v]:
                if ms[v] is None or ms[c] is None:
                    continue
                # best rank of c's subtree contribution within v's merge
                in_c = np.isin(ms[v], ms[c])
                ranks = np.flatnonzero(in_c)
                best = ranks[0] if len(ranks) else k
                if best >= pol.z * k:
                    keep[c] = False
        met2, st2 = run_query_reference(top, origin, p, child_mask=keep,
                                        return_state=True)
        # accuracy of round 2 vs round-1 TRUTH (the full reach set) —
        # pruning shrinks P_Q, so met2.accuracy alone would be trivially 1
        reached1 = st["reached"]
        idx1 = np.flatnonzero(reached1)
        true_scores = st["scores"][idx1].reshape(-1)
        top_true = np.sort(true_scores)[::-1][:k]
        got = st2["merged_scores"][origin]
        acc = float(np.intersect1d(top_true, got).size) / k \
            if got is not None else 0.0
        reduction = 1.0 - met2.total_bytes / max(met1.total_bytes, 1)
        return TopKResult(
            policy=pol.name, backend=self.backend, k=k,
            backend_used=used, topology=top.kind,
            latency_model=p.latency_model, metrics=_batch_of_one(met2),
            run_s=time.perf_counter() - t_start,
            extras={"metrics_full": met1, "metrics_pruned": met2,
                    "comm_reduction": reduction, "accuracy": acc,
                    "z": pol.z})
