"""SimEngine — the unified engine over the overlay simulator, with the
FD sweep on a torch device.

``prepare(topology)`` compiles a :class:`~repro_torch.engine.plan.
NetworkPlan` once; every subsequent ``run(spec, policy)`` reuses the
cached CSR, directed edges, per-origin BFS trees / forward masks,
auto-TTLs and device-resident depth slices.

This package carries ``fd-basic``, ``fd-st1``, ``fd-st1+2`` and
``fd-dynamic`` with or without churn (finite ``lifetime_mean_s``; §4.2
dead-parent rerouting under ``fd-dynamic``) and the ``cn`` / ``cn-star``
baselines, in float64, with iid link latencies.  In every RNG mode its
``TopKResult`` carries the reference package's bits (``values``,
``indices`` and every ``BatchMetrics`` field).  Everything else
(``fd-stats``, ``latency_model="edge"``, reduced precision, live
overlays) raises ``NotImplementedError`` naming the slice of the port
that will bring it — the engine never falls back to another path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.mesh import resolve_device
from repro_torch.engine.api import Engine, Policy, QuerySpec, TopKResult
from repro_torch.engine.plan import NetworkPlan
from repro_torch.engine.sim_torch import run_entries_torch
from repro_torch.kernels import _build
from repro_torch.p2psim.graph import Topology
from repro_torch.p2psim.metrics import QUERY_BYTES, BatchMetrics
from repro_torch.p2psim.simulate import SimParams

_BM_FIELDS = ("m_bw", "m_rt", "b_bw", "b_rt", "response_time_s", "accuracy")
_ALL_BM_FIELDS = ("n_reached", "n_edges_pq", "avg_degree", "m_fw",
                  "b_fw") + _BM_FIELDS


def _slice_rows(bm: BatchMetrics, lo: int, n_queries: int,
                n_trials: int) -> BatchMetrics:
    """Reshape rows [lo, lo + Q*T) of a flat (N, 1) batch to (Q, T)."""
    out = BatchMetrics.empty(bm.algorithm, n_queries, n_trials)
    hi = lo + n_queries * n_trials
    for f in _ALL_BM_FIELDS:
        getattr(out, f)[:] = getattr(bm, f)[lo:hi, 0].reshape(
            n_queries, n_trials)
    return out


def _unported(spec: QuerySpec, pol: Policy, p: SimParams) -> Optional[str]:
    """Why this package cannot run ``(spec, pol, p)`` yet, or None."""
    if pol.algorithm == "fd-stats":
        return ("policy 'fd-stats' comes with the slice that ports the "
                "scalar reference run")
    if pol.algorithm not in ("fd", "cn", "cn_star"):
        return f"algorithm {pol.algorithm!r} is not part of the port"
    if p.latency_model == "edge":
        return ("latency_model='edge' comes with the topology-registry "
                "slice of the port")
    if (spec.precision or "f64") != "f64":
        return (f"precision={spec.precision!r} comes with the "
                "reduced-precision slice of the port")
    return None


class SimEngine(Engine):
    """Unified Top-k engine over the overlay simulator, sweep on a torch
    device.

    ``device``: where the sweep runs — ``"cuda"`` by default (the
    hand-written kernels of ``repro_torch.kernels``), ``"cpu"`` for the
    kernels' plain PyTorch versions.  ``device=None`` without a CUDA
    device raises.  The first CUDA execution builds the kernel library;
    that time is booked in ``TopKResult.compile_s``.
    """

    backend = "sim-torch"

    def __init__(self, top: Optional[Union[Topology, NetworkPlan]] = None,
                 params: Optional[SimParams] = None, *, device=None):
        """Build the engine (and compile ``top``'s plan when given)."""
        self.device = resolve_device(device, "SimEngine")
        self.params = params if params is not None else SimParams()
        self.plan: Optional[NetworkPlan] = None
        if top is not None:
            self.prepare(top)

    def prepare(self, top: Union[Topology, NetworkPlan]) -> NetworkPlan:
        """Compile (or adopt) the overlay's NetworkPlan."""
        if isinstance(top, NetworkPlan):
            self.plan = top
        elif isinstance(top, Topology):
            self.plan = NetworkPlan(top)
        elif hasattr(top, "deltas_since"):
            raise NotImplementedError(
                "live overlays come with the overlay slice of the port; "
                "pass a frozen Topology")
        else:
            raise TypeError(
                f"expected a Topology or NetworkPlan, got {type(top)!r} "
                "(carry an overlay across with topology_from_arrays)")
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
            prec = spec.precision or "f64"
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
        if p.latency_model not in ("iid", "edge"):
            raise ValueError(f"latency_model must be 'iid' or 'edge', "
                             f"got {p.latency_model!r}")
        why = _unported(spec, pol, p)
        if why is not None:
            raise NotImplementedError(why)

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
                                self.device, replicas=rep)
        compile_s += res.pop("compile_s")
        run_s = time.perf_counter() - t0
        vals = res.pop("values")
        owns = res.pop("owners")

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
                          precision="f64",
                          values=vals.reshape(Q, T, p.k),
                          indices=owns.reshape(Q, T, p.k),
                          compile_s=compile_s, run_s=run_s)
