"""QuerySpec / Policy / TopKResult — the engine's shared vocabulary.

The paper's FD framework is "a family of algorithms" (FD-Basic,
Strategy 1, Strategy 1+2, FD-Dynamic, the CN/CN* baselines, and the
§3.3 statistics heuristic).  This module separates the three concerns
that the legacy string-flag surface conflated:

  * a **QuerySpec** says WHAT to ask — k, origins, trials, RNG mode;
  * a **Policy** says HOW to execute it — one named member of the
    algorithm family, owning its forward / merge / churn knobs;
  * an **engine backend** says WHERE it runs — in this package the
    overlay simulator whose sweep runs on a CUDA device (``SimEngine``).

A copy of the reference package's vocabulary, so that a result of the
port compares field by field with one of the reference.
"""
from __future__ import annotations

import abc
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.p2psim.metrics import BatchMetrics, QueryMetrics

RNG_MODES = ("shared", "independent")
LATENCY_MODELS = ("iid", "edge")
PRECISIONS = ("f64", "f32", "bf16")


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """What to ask: k, where queries originate, trials, RNG derivation.

    rng:
      * ``"shared"`` — one generator seeded ``seed`` issues batch-shaped
        draws (fast; a batch of one is bit-for-bit the scalar reference);
      * ``"independent"`` — entry (q, t) draws from its own generator
        seeded ``seed + q * n_trials + t`` and reproduces the scalar
        reference on that seed bit-for-bit, entry by entry.

    ``seeds`` — optional explicit (n_origins, n_trials) integer grid of
    per-entry seeds; implies ``rng="independent"``.

    ``latency_model`` — ``"iid"`` (paper Table 1: per-link N(200 ms,
    var) draws) or ``"edge"`` (BRITE distance-proportional latencies
    from the topology's embedding; needs a coordinate-carrying
    generator, see ``repro.p2psim.topologies``).  ``None`` defers to
    the engine's ``SimParams.latency_model``.

    ``precision`` — ``"f64"`` (default: the bit-exactness contract vs
    the scalar reference holds), or ``"f32"`` / ``"bf16"`` (jax backend
    only: the sweep runs in reduced precision and is validated against
    the f64 reference by a TOLERANCE contract — top-k set recall +
    score rtol, recorded in ``TopKResult.extras["tolerance"]`` — not
    bit-exactness).  ``None`` defers to the engine's configured
    precision.

    ``k`` / ``seed`` of None defer to the engine's ``SimParams``.  The
    device backend only reads ``k`` (scores are passed to ``run``).
    """

    origins: Tuple[int, ...] = (0,)
    n_trials: int = 1
    k: Optional[int] = None
    seed: Optional[int] = None
    rng: str = "shared"
    seeds: Optional[Any] = None
    latency_model: Optional[str] = None
    precision: Optional[str] = None

    def __post_init__(self):
        """Validate rng / n_trials / latency_model; seeds imply
        independent streams."""
        if self.rng not in RNG_MODES:
            raise ValueError(f"rng must be one of {RNG_MODES}, "
                             f"got {self.rng!r}")
        if self.n_trials < 1:
            raise ValueError(f"n_trials must be >= 1, got {self.n_trials}")
        if self.latency_model is not None \
                and self.latency_model not in LATENCY_MODELS:
            raise ValueError(
                f"latency_model must be one of {LATENCY_MODELS} (or "
                f"None to defer to SimParams), got {self.latency_model!r}")
        if self.precision is not None and self.precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS} (or None to "
                f"defer to the engine), got {self.precision!r}")
        if self.seeds is not None and self.rng != "independent":
            object.__setattr__(self, "rng", "independent")

    @property
    def independent(self) -> bool:
        """True when every entry draws from its own RNG stream."""
        return self.rng == "independent"


@dataclasses.dataclass(frozen=True)
class Policy:
    """How to execute: one named member of the paper's algorithm family.

    algorithm: ``"fd"`` | ``"cn"`` | ``"cn_star"`` | ``"fd-stats"``.
    ``strategy`` / ``dynamic`` are FD's forward- and merge-phase knobs
    (§3.3 strategies, §4 urgent lists + rerouting); ``lifetime_mean_s``
    is the churn knob (inf = static network); ``z`` is the fd-stats
    rank threshold (§3.3, Fig 7).
    """
    name: str
    algorithm: str
    strategy: str = "st1+2"
    dynamic: bool = True
    lifetime_mean_s: float = math.inf
    z: float = 0.8

    def variant(self, **overrides) -> "Policy":
        """A tweaked copy, e.g.
        ``get_policy("fd-dynamic").variant(lifetime_mean_s=60.0)``."""
        return dataclasses.replace(self, **overrides)


_REGISTRY: Dict[str, Policy] = {}


def register_policy(policy: Policy, *, overwrite: bool = False) -> Policy:
    """Add a policy to the global registry (error on duplicate names
    unless ``overwrite``)."""
    if not overwrite and policy.name in _REGISTRY:
        raise ValueError(f"policy {policy.name!r} already registered")
    _REGISTRY[policy.name] = policy
    return policy


def get_policy(policy) -> Policy:
    """Resolve a registered policy name; a ``Policy`` passes through."""
    if isinstance(policy, Policy):
        return policy
    try:
        return _REGISTRY[policy]
    except KeyError:
        raise KeyError(f"unknown policy {policy!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def available_policies() -> Tuple[str, ...]:
    """Registered policy names, in registration order."""
    return tuple(_REGISTRY)


# The family, named once (paper §3–§5).
register_policy(Policy("fd-basic", "fd", strategy="basic", dynamic=False))
register_policy(Policy("fd-st1", "fd", strategy="st1", dynamic=False))
register_policy(Policy("fd-st1+2", "fd", strategy="st1+2", dynamic=False))
register_policy(Policy("fd-dynamic", "fd", strategy="st1+2", dynamic=True))
register_policy(Policy("cn", "cn"))
register_policy(Policy("cn-star", "cn_star"))
register_policy(Policy("fd-stats", "fd-stats", z=0.8))


def policy_from_legacy(algorithm: str = "fd", strategy: str = "st1+2",
                       dynamic: bool = True,
                       lifetime_mean_s: float = math.inf) -> Policy:
    """Map the legacy ``run_query``/``run_queries`` kwargs to a policy.

    Combinations matching a registered policy resolve to it by name;
    anything else gets an anonymous policy carrying the same knobs.
    """
    for pol in _REGISTRY.values():
        if pol.algorithm != algorithm or pol.algorithm == "fd-stats":
            continue
        if algorithm in ("cn", "cn_star") or (
                pol.strategy == strategy and pol.dynamic == dynamic):
            base = pol
            break
    else:
        tag = "dynamic" if dynamic else "static"
        base = Policy(f"{algorithm}[{strategy},{tag}]", algorithm,
                      strategy=strategy, dynamic=dynamic)
    if not math.isinf(lifetime_mean_s):
        base = base.variant(lifetime_mean_s=lifetime_mean_s)
    return base


@dataclasses.dataclass
class TopKResult:
    """What every backend returns.

    The sim backend fills ``metrics`` (per-entry ``BatchMetrics``); the
    device backend fills ``values`` / ``indices`` (and ``rows`` on the
    data-retrieval gather path).  ``extras`` carries backend specifics:
    fd-stats round metrics, the device comm-model bytes, ...

    ``backend`` names the engine the caller constructed;
    ``backend_used`` records the path that actually executed (defaults
    to ``backend``).  They differ only when an engine falls back — e.g.
    ``fd-stats`` on ``SimEngine(backend="jax")`` runs the numpy
    reference rounds — so tests can assert no SILENT fallback:
    ``assert res.backend_used == res.backend``.

    ``topology`` / ``latency_model`` record WHAT overlay the result was
    measured on (the topology family's registered ``kind`` and the
    effective link-latency regime) — the sim backends fill them, the
    device backend has no overlay and leaves them ``None``.

    ``precision`` records the arithmetic the executed sweep ran in:
    ``"f64"`` results are bit-exact vs the scalar reference; ``"f32"``
    / ``"bf16"`` results are tolerance-checked instead, and
    ``extras["tolerance"]`` carries the measured contract (top-k
    recall + score rtol vs the f64 sweep) when the caller requested
    validation.

    Serving metadata (every backend fills these; the serving layer in
    ``repro.engine.serve`` aggregates them into its per-request
    timings):

    * ``queue_s`` — seconds the request waited before execution began.
      Backends set 0.0 (a direct ``run`` never queues); the
      ``QueryServer`` dispatcher overwrites it with the measured
      enqueue-to-dispatch wait.
    * ``compile_s`` — seconds of plan / trace preparation attributable
      to this call: origin-statics compilation on the sim backends
      (0.0 on a warm ``NetworkPlan``), jitted-callable construction on
      the device backend.
    * ``run_s`` — wall seconds of the executed sweep itself (on the
      jax backends this includes XLA tracing on the first call for a
      given tree profile; warm calls are pure execution).
    * ``batch_size`` — how many requests shared the executed sweep: 1
      for a direct ``run``, the coalesced group size when
      ``Engine.run_many`` (or the server's dynamic batcher) fused this
      request with others.  Fused requests report the SAME
      ``compile_s`` / ``run_s`` (the one sweep they shared).
    """

    policy: str
    backend: str                       # "sim-torch" in this package
    k: int
    backend_used: Optional[str] = None
    topology: Optional[str] = None     # overlay family (sim backends)
    latency_model: Optional[str] = None  # "iid" | "edge" (sim backends)
    precision: str = "f64"             # arithmetic the sweep ran in
    metrics: Optional[BatchMetrics] = None
    values: Any = None
    indices: Any = None
    rows: Any = None
    queue_s: float = 0.0               # wait before execution (server)
    compile_s: float = 0.0             # plan/trace prep for this call
    run_s: float = 0.0                 # executed-sweep wall seconds
    batch_size: int = 1                # requests sharing the sweep
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        """Default ``backend_used`` to the constructed backend."""
        if self.backend_used is None:
            self.backend_used = self.backend

    def query_metrics(self, q: int = 0, t: int = 0) -> QueryMetrics:
        """Scalar per-query metrics (sim backend only)."""
        if self.metrics is None:
            raise ValueError(
                f"the {self.backend!r} backend has no per-query metrics")
        return self.metrics.query_metrics(q, t)

    def summary(self) -> dict:
        """Flat scalar summary: identity fields + metric means +
        scalar extras."""
        out = {"policy": self.policy, "backend": self.backend, "k": self.k}
        if self.topology is not None:
            out["topology"] = self.topology
        if self.latency_model is not None:
            out["latency_model"] = self.latency_model
        if self.metrics is not None:
            out.update(self.metrics.summary())
        out.update({key: v for key, v in self.extras.items()
                    if isinstance(v, (int, float, str, bool))})
        return out


PolicyLike = Union[str, Policy]


class Engine(abc.ABC):
    """The backend contract every engine implements.

    An engine is a LONG-LIVED object: it owns compiled per-overlay /
    per-mesh state (``NetworkPlan``, jit traces, compiled collectives)
    and amortizes it across calls.  Two entrypoints:

    * ``run(spec, policy)`` — one ``QuerySpec``, one ``TopKResult``;
    * ``run_many(specs, policies)`` — a request batch.  Backends group
      COMPATIBLE specs (same policy and effective execution signature)
      onto one batched sweep and split the results back out, so ``N``
      concurrent requests cost one sweep instead of ``N`` — this is
      the call the serving layer's dynamic batcher makes.  Results are
      positionally matched to ``specs`` and each is entry-wise
      bit-exact with what a sequential ``run`` would have returned.

    The base-class ``run_many`` is the trivially correct sequential
    fallback; ``SimEngine`` / ``DeviceEngine`` override it with real
    coalescing.
    """

    #: engine identity recorded on every TopKResult ("sim-torch" for
    #: the port's SimEngine); subclasses overwrite it
    backend = "abstract"

    @abc.abstractmethod
    def run(self, spec: Optional[QuerySpec] = None,
            policy: PolicyLike = "fd-dynamic", **kwargs) -> TopKResult:
        """Execute one ``QuerySpec`` under ``policy``."""

    def run_many(self, specs: Sequence[QuerySpec],
                 policies: Union[PolicyLike, Sequence[PolicyLike]]
                 = "fd-dynamic", **kwargs) -> List[TopKResult]:
        """Execute a batch of specs; result ``i`` answers ``specs[i]``.

        ``policies`` is one policy applied to every spec or a sequence
        zipped with ``specs``.  This default implementation runs the
        specs sequentially — correct for any backend, no coalescing.
        """
        pols = self._zip_policies(specs, policies)
        return [self.run(s, p, **kwargs) for s, p in zip(specs, pols)]

    @staticmethod
    def _zip_policies(specs: Sequence[QuerySpec],
                      policies) -> List[Policy]:
        """Resolve ``policies`` into one ``Policy`` per spec."""
        if isinstance(policies, (str, Policy)):
            return [get_policy(policies)] * len(specs)
        pols = [get_policy(p) for p in policies]
        if len(pols) != len(specs):
            raise ValueError(f"got {len(specs)} specs but {len(pols)} "
                             "policies")
        return pols
