"""DeviceEngine — the QuerySpec/Policy surface over the FD collectives.

Wraps ``fd_topk`` / ``fd_topk_gather`` (``core/fd.py``: virtual peers
on one device, the ``ppermute`` schedules as the merge-and-backward
phase, the top-k and merge kernels on the card) behind the same engine
API as ``SimEngine``.  The compiled plan of a call is its schedule's
permutation and mask index tensors on the device, and on a mesh over
ranks this rank's send and receive lists of each round: cached per
(path, k, algorithm, schedule), so a repeated ``run`` on the same mesh
reuses them.

Over ranks (a mesh built with a process group), every rank runs the
same calls on its own block of the scores (..., N / R) and of the rows
(N / R, d); each gets its first local peer's answer, and
``TopKResult.extras["sent_bytes"]`` holds the bytes this rank delivered
to other ranks during the call.

Policy mapping: every ``fd-*`` policy lowers to the FD collective (the
program *is* the query — flooding at build time makes the §3.3 forward
strategies and §4 churn handling moot on a reliable fabric);
``cn`` / ``cn-star`` lower to the paper's baselines; ``fd-stats`` has
no device backend.

Spans (``runtime/spans.py``): ``run_many``, and within it
``run_many.inputs`` (casts and grouping), ``run_many.stack``,
``run_many.sync``, ``run_many.results`` (a ``TopKResult`` a query) and
``run_many.unfused`` (a call that is not stacked); the counter
``engine.plan_builds`` counts the plans built (misses of the cache).

A port of the reference's ``repro/engine/device.py``.
"""
from __future__ import annotations

import functools
import time
from typing import List, Optional, Sequence, Union

import torch

from repro_torch.core import fd
from repro_torch.engine.api import (PRECISIONS, Engine, Policy, QuerySpec,
                                    TopKResult)
from repro_torch.engine.precision import torch_dtype
from repro_torch.kernels import _build
from repro_torch.runtime.spans import count, span

_DEVICE_ALGOS = ("fd", "cn", "cn_star")
_REPORTED = {torch.float32: "f32", torch.bfloat16: "bf16"}


class DeviceEngine(Engine):
    """Unified Top-k engine backend over a mesh of virtual peers.

    The engine runs on the mesh's device (``make_mesh`` puts it on
    ``"cuda"`` unless told otherwise); scores and rows given as numpy
    arrays or as tensors on another device are moved there.  The first
    CUDA call builds the kernel library and books that time in
    ``TopKResult.compile_s``.

    ``precision``: ``None`` (default) runs the collectives in whatever
    dtype the caller's scores carry.  ``"f64"`` / ``"f32"`` / ``"bf16"``
    casts the inputs once before dispatch and records the mode on
    ``TopKResult.precision``.  The local top-k computes in f32, so
    ``"bf16"`` QUANTIZES the scores to bf16 and then merges in f32 —
    identical bits to casting the scores by hand.
    """

    backend = "device-torch"

    def __init__(self, mesh=None, axis: str = "model", *,
                 schedule: str = "halving", batch_axes=None,
                 precision: Optional[str] = None):
        """Build the engine (and bind ``mesh`` when given)."""
        if precision is not None and precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS} (or None), "
                f"got {precision!r}")
        self.axis = axis
        self.schedule = schedule
        self.batch_axes = batch_axes
        self.precision = precision
        self.mesh = None
        self._compiled: dict = {}
        if mesh is not None:
            self.prepare(mesh)

    def _tensor(self, x):
        """``x`` (numpy or a tensor anywhere; over ranks, this rank's
        block) as a tensor on the mesh's device."""
        return torch.as_tensor(x).to(self.mesh.device)

    def _cast(self, scores):
        """Scores on the device in the requested precision (None =
        as-is)."""
        scores = self._tensor(scores)
        if self.precision is None:
            return scores
        return scores.to(torch_dtype(self.precision))

    def prepare(self, mesh):
        """Bind (or rebind) the mesh; drops stale compiled plans."""
        self.mesh = mesh
        self._compiled.clear()
        return mesh

    @property
    def axis_size(self) -> int:
        """Peer count along the engine's collective axis."""
        return self.mesh.shape[self.axis]

    def _fn(self, path: str, k: int, algorithm: str):
        """The cached callable of (path, k, algorithm, schedule) and the
        seconds spent building it now (0.0 when cached)."""
        key = (path, k, algorithm, self.schedule)
        fn = self._compiled.get(key)
        if fn is not None:
            return fn, 0.0
        count("engine.plan_builds")
        t0 = time.perf_counter()
        if self.mesh.device.type == "cuda":
            _build.ensure_built()
        rounds = (fd.schedule_rounds(self.schedule, self.axis_size,
                                     self.mesh.device,
                                     self.mesh.axis(self.axis))
                  if algorithm == "fd" else None)
        if path == "gather":
            fn = functools.partial(
                fd.fd_topk_gather, k=k, mesh=self.mesh, axis=self.axis,
                schedule=self.schedule, batch_axes=self.batch_axes,
                rounds=rounds)
        else:
            fn = functools.partial(
                fd.fd_topk, k=k, mesh=self.mesh, axis=self.axis,
                schedule=self.schedule, algorithm=algorithm,
                batch_axes=self.batch_axes, rounds=rounds)
        self._compiled[key] = fn
        return fn, time.perf_counter() - t0

    def _sync(self) -> None:
        """Wait for the device (a CUDA call returns before it ends).
        Exchanges between ranks have ended by then: each collective
        waits for its messages before it returns."""
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)

    def run(self, spec: Optional[QuerySpec] = None,
            policy: Union[str, Policy] = "fd-dynamic", *,
            scores, rows=None) -> TopKResult:
        """Top-k of ``scores`` (sharded over ``axis``) under ``policy``.

        ``rows`` — optional (N, d) sharded table: runs the phase-4
        data-retrieval gather and fills ``TopKResult.rows`` (FD only).
        Only ``spec.k`` is read from the spec on this backend.  This is
        the batch-of-1 case of :meth:`run_many`.
        """
        spec = spec if spec is not None else QuerySpec()
        return self.run_many([spec], [policy], scores=[scores],
                             rows=None if rows is None else [rows])[0]

    def run_many(self, specs: Sequence[QuerySpec],
                 policies: Union[str, Policy,
                                 Sequence[Union[str, Policy]]]
                 = "fd-dynamic", *, scores: Sequence,
                 rows: Optional[Sequence] = None) -> List[TopKResult]:
        """Execute a request batch; ``scores[i]`` answers ``specs[i]``.

        Requests with 1-D score vectors of identical shape/dtype, the
        same effective ``k`` and the same lowered collective (all
        ``fd-*`` policies share the FD program) are STACKED onto one
        batched collective call, each row recovering exactly the bits
        its solo call would produce (the collectives are elementwise per
        batch row).  Gather-path requests (``rows``) and pre-batched
        score arrays run individually.  ``rows`` is an optional per-spec
        sequence (``None`` entries take the plain top-k path).
        """
        if self.mesh is None:
            raise RuntimeError("call DeviceEngine.prepare(mesh) first")
        with span("run_many"):
            return self._run_many(specs, policies, scores, rows)

    def _run_many(self, specs, policies, scores, rows):
        with span("run_many.inputs"):
            pols = self._zip_policies(specs, policies)
            scores = [self._cast(s) for s in scores]
            row_seq = (list(rows) if rows is not None
                       else [None] * len(specs))
            if len(scores) != len(specs) or len(row_seq) != len(specs):
                raise ValueError(
                    f"need one scores (and rows) entry per spec: "
                    f"{len(specs)} specs, {len(scores)} scores, "
                    f"{len(row_seq)} rows")
            results: List[Optional[TopKResult]] = [None] * len(specs)
            groups: dict = {}           # exec signature -> [index]
            unfused = []                # (index, k) of the unstacked
            for i, (spec, pol) in enumerate(zip(specs, pols)):
                if pol.algorithm not in _DEVICE_ALGOS:
                    raise ValueError(
                        f"policy {pol.name!r} (algorithm "
                        f"{pol.algorithm!r}) has no device backend; use "
                        f"one of {_DEVICE_ALGOS}")
                k = spec.k if spec.k is not None else 20
                s = scores[i]
                if row_seq[i] is not None or s.dim() != 1:
                    unfused.append((i, k))
                    continue
                key = (pol.algorithm, k, tuple(s.shape), s.dtype)
                groups.setdefault(key, []).append(i)
        for i, k in unfused:
            results[i] = self._run_one(pols[i], k, scores[i], row_seq[i])
        for (algorithm, k, _, _), idxs in groups.items():
            if len(idxs) == 1:
                i = idxs[0]
                results[i] = self._run_one(pols[i], k, scores[i], None)
                continue
            with span("run_many.stack"):
                stacked = torch.stack([scores[i] for i in idxs])
            fn, compile_s = self._fn("topk", k, algorithm)
            t0, sent0 = time.perf_counter(), self.mesh.sent_bytes
            vals, idx = fn(stacked)
            with span("run_many.sync"):
                self._sync()
            run_s = time.perf_counter() - t0
            with span("run_many.results"):
                for b, i in enumerate(idxs):
                    res = self._result(pols[i], k, scores[i], vals[b],
                                       idx[b], None, sent0)
                    res.compile_s, res.run_s = compile_s, run_s
                    res.batch_size = len(idxs)
                    results[i] = res
        return results

    def _run_one(self, pol: Policy, k: int, scores, rows) -> TopKResult:
        """One unfused collective call (gather / pre-batched / solo)."""
        with span("run_many.unfused"):
            if rows is not None:
                if pol.algorithm != "fd":
                    raise ValueError(
                        "the data-retrieval gather path is FD-only "
                        "(CN ships whole shards, not k rows)")
                fn, compile_s = self._fn("gather", k, pol.algorithm)
                rows = self._tensor(rows)
                t0, sent0 = time.perf_counter(), self.mesh.sent_bytes
                vals, idx, got = fn(scores, rows)
            else:
                fn, compile_s = self._fn("topk", k, pol.algorithm)
                t0, sent0 = time.perf_counter(), self.mesh.sent_bytes
                (vals, idx), got = fn(scores), None
            self._sync()
            res = self._result(pol, k, scores, vals, idx, got, sent0)
            res.compile_s, res.run_s = compile_s, time.perf_counter() - t0
            return res

    def _result(self, pol: Policy, k: int, scores, vals, idx,
                got, sent0: int) -> TopKResult:
        """Assemble a TopKResult (+ the comm-model bytes extra, and over
        ranks the bytes this rank sent)."""
        # precision=None runs in the caller's dtype; report what ran
        prec = self.precision or _REPORTED.get(vals.dtype, "f64")
        extras = {}
        n, local = scores.shape[-1], self.mesh.axis(self.axis).local
        if n % local == 0:
            extras["model_bytes"] = fd.comm_bytes(
                pol.algorithm, self.axis_size, n // local, k,
                schedule=self.schedule)
        if self.mesh.multi_rank:
            extras["sent_bytes"] = self.mesh.sent_bytes - sent0
        return TopKResult(policy=pol.name, backend=self.backend, k=k,
                          values=vals, indices=idx, rows=got,
                          precision=prec, extras=extras)
