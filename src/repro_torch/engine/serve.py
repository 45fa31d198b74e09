"""QueryServer — the always-on serving layer over long-lived engines.

A copy of the reference package's engine-agnostic serving layer: a
``QueryServer`` hosts warm, long-lived engines (the port's
``SimEngine``, which runs its sweep on a CUDA device) behind a bounded
request queue and a dynamic batcher:

  * **requests** are ``(QuerySpec, policy, engine)`` triples submitted
    from any thread; ``submit`` returns a :class:`QueryHandle` future;
  * a single **dispatcher thread** pulls a batch off the queue — up to
    ``max_batch`` requests, waiting at most ``batch_window_s`` after the
    first — and hands each engine's share to ``Engine.run_many``, which
    coalesces compatible specs onto ONE batched sweep (reusing the
    plan's cached ``NetworkPlan`` / ``DepthSlices`` and device tensors),
    so N concurrent queries on a warm overlay cost one sweep;
  * the queue is **bounded**: when it is full, ``submit`` sheds the
    request immediately and deterministically with
    :class:`ServerOverloaded` — the overload signal IS the error, no
    request is silently dropped;
  * every request may carry a **timeout**: a request whose deadline has
    passed when the dispatcher picks it up completes with
    :class:`RequestTimeout` instead of executing (queueing time is the
    only thing a shed saves — execution is never interrupted mid-sweep);
  * **serving metrics** — queue depth, batch-size histogram, shed /
    timeout counters, per-request queue / compile / run timings — are
    aggregated continuously and snapshot via :meth:`QueryServer.metrics`.

Batching changes no bits: results are entry-wise identical to a
sequential ``engine.run`` per request (``Engine.run_many``'s contract,
asserted by tests/test_torch_serving.py).  An engine failure is
counted in ``ServerMetrics.failed`` and raised from the request's
handle, so a caller that checks neither hides it.

    from repro_torch.engine import QueryServer, QuerySpec, SimEngine

    server = QueryServer(SimEngine(topology))          # on "cuda"
    with server:                               # start() / stop()
        handles = [server.submit(QuerySpec(origins=(o,), seed=s))
                   for s, o in enumerate(origins)]
        results = [h.result(timeout=5) for h in handles]
    server.metrics().batch_hist                # {sweep size: count}
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.engine.api import Engine, Policy, QuerySpec, TopKResult


class ServerError(RuntimeError):
    """Base class for serving-layer failures."""


class ServerOverloaded(ServerError):
    """The bounded request queue was full: the request was shed."""


class RequestTimeout(ServerError):
    """The request's deadline expired before its sweep was dispatched."""


class ServerClosed(ServerError):
    """The server was stopped before the request could execute."""


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    """Submit-to-completion latency percentiles over served requests."""

    mean_s: float
    p50_s: float
    p95_s: float
    p99_s: float


@dataclasses.dataclass(frozen=True)
class PhaseStats:
    """Mean / max of one per-request phase timing (queue wait, run)."""

    mean: float
    max: float


@dataclasses.dataclass(frozen=True)
class ServerMetrics:
    """Typed snapshot of :meth:`QueryServer.metrics`.

    Counters count REQUESTS (``submitted`` includes everything accepted
    into the queue; ``shed`` requests were never queued).  ``batch_hist``
    histograms ``TopKResult.batch_size`` over served requests — how many
    requests shared each executed sweep; ``dispatch_hist`` histograms
    how many requests each dispatcher cycle pulled.  ``latency`` /
    ``queue_s`` / ``run_s`` are ``None`` until a request completes.

    ``as_dict()`` is the back-compat escape hatch: it returns exactly
    the flat dict the pre-typed ``metrics()`` produced (timing keys
    absent when no request has completed), so existing JSON emitters
    keep working unchanged.
    """

    submitted: int
    served: int
    shed: int
    timed_out: int
    failed: int
    queue_depth: int
    max_queue_depth: int
    batch_hist: Dict[int, int]
    dispatch_hist: Dict[int, int]
    mean_batch: float
    max_batch: int
    latency: Optional[LatencyStats] = None
    queue_s: Optional[PhaseStats] = None
    run_s: Optional[PhaseStats] = None

    def as_dict(self) -> dict:
        """The legacy flat-dict shape (see class docstring)."""
        out = {
            "submitted": self.submitted, "served": self.served,
            "shed": self.shed, "timed_out": self.timed_out,
            "failed": self.failed, "queue_depth": self.queue_depth,
            "max_queue_depth": self.max_queue_depth,
            "batch_hist": dict(self.batch_hist),
            "dispatch_hist": dict(self.dispatch_hist),
            "mean_batch": self.mean_batch, "max_batch": self.max_batch,
        }
        if self.latency is not None:
            out["latency"] = dataclasses.asdict(self.latency)
            out["queue_s"] = dataclasses.asdict(self.queue_s)
            out["run_s"] = dataclasses.asdict(self.run_s)
        return out


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Serving knobs.

    * ``max_queue`` — bound of the request queue; a full queue sheds
      (``submit`` raises :class:`ServerOverloaded`).
    * ``max_batch`` — most requests one dispatcher cycle hands to
      ``run_many`` (the dynamic batcher's ceiling).
    * ``batch_window_s`` — how long the dispatcher lingers after the
      first dequeued request to let concurrent arrivals coalesce.
      Immediately available requests are always drained regardless.
    * ``default_timeout_s`` — per-request deadline applied when
      ``submit`` passes none (``None`` = no deadline).
    """

    max_queue: int = 256
    max_batch: int = 64
    batch_window_s: float = 0.002
    default_timeout_s: Optional[float] = None


class QueryHandle:
    """Future for one submitted request.

    ``result(timeout)`` blocks until the dispatcher completes the
    request and returns its ``TopKResult`` (with ``queue_s`` /
    ``compile_s`` / ``run_s`` / ``batch_size`` filled in) or raises the
    request's failure (:class:`RequestTimeout`, :class:`ServerClosed`,
    or whatever the engine raised).
    """

    __slots__ = ("spec", "policy", "engine_name", "deadline", "t_submit",
                 "_event", "_result", "_error")

    def __init__(self, spec: QuerySpec, policy: Policy, engine_name: str,
                 deadline: Optional[float]):
        """Bind the request triple; the server completes the handle."""
        self.spec = spec
        self.policy = policy
        self.engine_name = engine_name
        self.t_submit = time.perf_counter()
        self.deadline = deadline
        self._event = threading.Event()
        self._result: Optional[TopKResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        """True once the request completed (result or error)."""
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> TopKResult:
        """Block for the result; raise the request's failure if any."""
        if not self._event.wait(timeout):
            raise TimeoutError("request not completed within "
                               f"{timeout} s (still queued or running)")
        if self._error is not None:
            raise self._error
        return self._result

    def exception(self,
                  timeout: Optional[float] = None) -> \
            Optional[BaseException]:
        """Block for completion; return the failure (None on success)."""
        if not self._event.wait(timeout):
            raise TimeoutError("request not completed within "
                               f"{timeout} s (still queued or running)")
        return self._error

    # -- completion (server side) -----------------------------------------

    def _complete(self, result: Optional[TopKResult],
                  error: Optional[BaseException]) -> None:
        self._result, self._error = result, error
        self._event.set()


class QueryServer:
    """Long-lived query service over one or more warm engines.

    ``engines`` — a single :class:`~repro_torch.engine.api.Engine`
    (registered under the name ``"default"``) or a dict naming several,
    e.g. one ``SimEngine`` per hosted overlay.  Engines stay alive (and
    warm: compiled plans, depth slices, device tensors, the kernel
    library) for the server's whole lifetime — that is the point.

    The dispatcher is a single thread: one sweep executes at a time,
    which is exactly what dynamic batching wants (concurrent requests
    coalesce instead of contending).  ``submit`` is thread-safe and may
    be called before ``start`` — queued requests are served once the
    dispatcher runs (tests use this to exercise shedding
    deterministically).
    """

    def __init__(self, engines: Union[Engine, Dict[str, Engine]],
                 config: Optional[ServerConfig] = None):
        """Register ``engines`` and size the bounded queue."""
        if isinstance(engines, Engine):
            engines = {"default": engines}
        if not engines:
            raise ValueError("QueryServer needs at least one engine")
        self.engines: Dict[str, Engine] = dict(engines)
        self.config = config if config is not None else ServerConfig()
        self._queue: "queue.Queue[QueryHandle]" = queue.Queue(
            maxsize=self.config.max_queue)
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._counters = {"submitted": 0, "served": 0, "shed": 0,
                          "timed_out": 0, "failed": 0}
        self._batch_hist: Dict[int, int] = {}
        self._dispatch_sizes: Dict[int, int] = {}
        self._max_queue_depth = 0
        self._records: List[tuple] = []   # (total_s, queue_s, run_s)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "QueryServer":
        """Start the dispatcher thread (idempotent)."""
        if self._closed:
            raise ServerClosed("server already stopped")
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._serve_loop, name="fd-query-server",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop accepting requests and shut the dispatcher down.

        ``drain=True`` serves everything already queued first;
        ``drain=False`` fails pending requests with
        :class:`ServerClosed`.
        """
        self._closed = True
        if self._thread is None:
            self._fail_pending(ServerClosed("server never started"))
            return
        if drain:
            self._queue.join()
        self._stop.set()
        self._thread.join(timeout)
        self._thread = None
        self._fail_pending(ServerClosed("server stopped"))

    def __enter__(self) -> "QueryServer":
        """Context manager: ``start`` on entry."""
        return self.start()

    def __exit__(self, *exc) -> None:
        """Context manager: draining ``stop`` on exit."""
        self.stop(drain=exc == (None, None, None))

    # -- client surface ----------------------------------------------------

    def submit(self, spec: Optional[QuerySpec] = None,
               policy: Union[str, Policy] = "fd-dynamic",
               engine: Optional[str] = None,
               timeout_s: Optional[float] = None) -> QueryHandle:
        """Enqueue one request; returns its :class:`QueryHandle`.

        Raises :class:`ServerOverloaded` IMMEDIATELY when the bounded
        queue is full (graceful shedding — the caller knows at submit
        time) and :class:`ServerClosed` after ``stop``.
        """
        if self._closed:
            raise ServerClosed("server is stopped")
        name = self._resolve_engine(engine)
        pol = self.engines[name]._zip_policies((None,), policy)[0]
        if timeout_s is None:
            timeout_s = self.config.default_timeout_s
        handle = QueryHandle(
            spec if spec is not None else QuerySpec(), pol, name,
            None if timeout_s is None
            else time.perf_counter() + timeout_s)
        try:
            self._queue.put_nowait(handle)
        except queue.Full:
            with self._lock:
                self._counters["shed"] += 1
            raise ServerOverloaded(
                f"request queue full ({self.config.max_queue} pending); "
                "request shed") from None
        with self._lock:
            self._counters["submitted"] += 1
            self._max_queue_depth = max(self._max_queue_depth,
                                        self._queue.qsize())
        return handle

    def query(self, spec: Optional[QuerySpec] = None,
              policy: Union[str, Policy] = "fd-dynamic",
              engine: Optional[str] = None,
              timeout_s: Optional[float] = None) -> TopKResult:
        """``submit`` + blocking ``result`` in one call."""
        return self.submit(spec, policy, engine, timeout_s).result()

    def warm(self, spec: Optional[QuerySpec] = None,
             policy: Union[str, Policy] = "fd-dynamic",
             engine: Optional[str] = None,
             batch_sizes: Optional[Sequence[int]] = None,
             **kwargs) -> TopKResult:
        """Run one query DIRECTLY on an engine (no queue) to populate
        its plan / trace caches before taking load.  Call before
        ``start`` or while the server is idle — engines are owned by
        the dispatcher thread once traffic flows.

        ``batch_sizes`` — optionally also pre-trace FUSED dispatch
        shapes: for each ``b`` the spec is replicated ``b`` times
        through ``run_many``, exactly the call the dispatcher makes for
        a coalesced batch of ``b`` identical requests, so the caches
        the fused sweep reads are built before traffic flows — live
        dispatches then report ``compile_s == 0``."""
        name = self._resolve_engine(engine)
        eng = self.engines[name]
        if batch_sizes:
            res = None
            base = spec if spec is not None else QuerySpec()
            for b in batch_sizes:
                if b < 1:
                    raise ValueError(f"batch sizes must be >= 1, got {b}")
                res = eng.run_many([base] * int(b), policy, **kwargs)[-1]
            return res
        return eng.run(spec, policy, **kwargs)

    def metrics(self) -> ServerMetrics:
        """Snapshot of the serving counters and timing aggregates as a
        typed :class:`ServerMetrics` (``.as_dict()`` recovers the old
        flat-dict shape)."""
        with self._lock:
            counters = dict(self._counters)
            hist = dict(self._batch_hist)
            dispatch = dict(self._dispatch_sizes)
            depth_max = self._max_queue_depth
            rec = list(self._records)
        n = sum(hist.values())
        latency = queue_s = run_s = None
        if rec:
            arr = np.asarray(rec)
            latency = LatencyStats(
                mean_s=float(arr[:, 0].mean()),
                p50_s=float(np.percentile(arr[:, 0], 50)),
                p95_s=float(np.percentile(arr[:, 0], 95)),
                p99_s=float(np.percentile(arr[:, 0], 99)))
            queue_s = PhaseStats(mean=float(arr[:, 1].mean()),
                                 max=float(arr[:, 1].max()))
            run_s = PhaseStats(mean=float(arr[:, 2].mean()),
                               max=float(arr[:, 2].max()))
        return ServerMetrics(
            submitted=counters["submitted"], served=counters["served"],
            shed=counters["shed"], timed_out=counters["timed_out"],
            failed=counters["failed"],
            queue_depth=self._queue.qsize(),
            max_queue_depth=depth_max,
            batch_hist=hist, dispatch_hist=dispatch,
            mean_batch=(sum(s * c for s, c in hist.items()) / n
                        if n else 0.0),
            max_batch=max(hist) if hist else 0,
            latency=latency, queue_s=queue_s, run_s=run_s)

    # -- dispatcher --------------------------------------------------------

    def _resolve_engine(self, engine: Optional[str]) -> str:
        if engine is None:
            if len(self.engines) == 1:
                return next(iter(self.engines))
            raise ValueError(
                "several engines are hosted "
                f"({sorted(self.engines)}); name one")
        if engine not in self.engines:
            raise KeyError(f"unknown engine {engine!r}; hosted: "
                           f"{sorted(self.engines)}")
        return engine

    def _serve_loop(self) -> None:
        """Dispatcher: drain → coalesce (window) → run_many → complete."""
        cfg = self.config
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.02)
            except queue.Empty:
                continue
            batch = [first]
            window_end = time.perf_counter() + cfg.batch_window_s
            while len(batch) < cfg.max_batch:
                try:                       # drain what's already there
                    batch.append(self._queue.get_nowait())
                    continue
                except queue.Empty:
                    pass
                rem = window_end - time.perf_counter()
                if rem <= 0:
                    break
                try:                       # linger for stragglers
                    batch.append(self._queue.get(timeout=rem))
                except queue.Empty:
                    break
            try:
                self._dispatch(batch)
            finally:
                for _ in batch:
                    self._queue.task_done()

    def _dispatch(self, batch: List[QueryHandle]) -> None:
        """Execute one dequeued batch: timeouts, per-engine run_many."""
        now = time.perf_counter()
        with self._lock:
            self._dispatch_sizes[len(batch)] = \
                self._dispatch_sizes.get(len(batch), 0) + 1
        by_engine: Dict[str, List[QueryHandle]] = {}
        for h in batch:
            if h.deadline is not None and now >= h.deadline:
                with self._lock:
                    self._counters["timed_out"] += 1
                h._complete(None, RequestTimeout(
                    "request waited "
                    f"{now - h.t_submit:.3f} s in queue, past its "
                    "deadline; dropped before execution"))
                continue
            by_engine.setdefault(h.engine_name, []).append(h)
        for name, handles in by_engine.items():
            try:
                results = self.engines[name].run_many(
                    [h.spec for h in handles],
                    [h.policy for h in handles])
            except Exception as e:             # noqa: BLE001 — the whole
                with self._lock:               # group shares the failure
                    self._counters["failed"] += len(handles)
                for h in handles:
                    h._complete(None, e)
                continue
            done = time.perf_counter()
            with self._lock:
                for h, res in zip(handles, results):
                    res.queue_s = now - h.t_submit
                    self._counters["served"] += 1
                    self._batch_hist[res.batch_size] = \
                        self._batch_hist.get(res.batch_size, 0) + 1
                    self._records.append(
                        (done - h.t_submit, res.queue_s, res.run_s))
                if len(self._records) > 200_000:   # bound the buffer
                    del self._records[:100_000]
            for h, res in zip(handles, results):
                h._complete(res, None)

    def _fail_pending(self, err: ServerError) -> None:
        """Complete everything still queued with ``err``."""
        while True:
            try:
                h = self._queue.get_nowait()
            except queue.Empty:
                return
            with self._lock:
                self._counters["failed"] += 1
            h._complete(None, err)
            self._queue.task_done()
