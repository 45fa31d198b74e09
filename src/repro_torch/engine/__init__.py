"""Unified Top-k query engine of the port: QuerySpec + Policy registry +
compiled NetworkPlan, with the FD sweep on a torch device.

    from repro_torch.engine import SimEngine, QuerySpec

    engine = SimEngine(topology)            # on "cuda"; device="cpu" too
    res = engine.run(QuerySpec(origins=(0, 7), n_trials=4), "fd-dynamic")
    res.metrics.summary()                   # per-entry BatchMetrics

Bound to a live ``Overlay``, the engine re-syncs its plan before every
execution, so peers may join and leave between queries:

    ov = Overlay(topology)
    engine = SimEngine(ov)
    ov.remove_peer(7, repair="reconnect")
    engine.run(QuerySpec(origins=(0,)))     # plan synced incrementally

For sustained concurrent load, ``QueryServer`` hosts warm engines
behind a bounded queue and a dynamic batcher that coalesces compatible
requests onto one sweep via ``Engine.run_many``:

    with QueryServer(SimEngine(topology)) as server:
        handle = server.submit(QuerySpec(origins=(0,)), "fd-dynamic")
        res = handle.result()

``DeviceEngine`` exposes the same surface over the FD collectives of
``repro_torch.core.fd`` (virtual peers on one device):

    from repro_torch.core.mesh import make_mesh
    engine = DeviceEngine(make_mesh((64,), ("model",)))   # on "cuda"
    res = engine.run(QuerySpec(k=20), "fd-dynamic", scores=scores)
"""
from repro_torch.engine.api import (Engine, Policy,  # noqa: F401
                                    QuerySpec, TopKResult,
                                    available_policies, get_policy,
                                    policy_from_legacy, register_policy)
from repro_torch.engine.device import DeviceEngine  # noqa: F401
from repro_torch.engine.plan import NetworkPlan  # noqa: F401
from repro_torch.engine.serve import (LatencyStats,  # noqa: F401
                                      PhaseStats, QueryHandle, QueryServer,
                                      RequestTimeout, ServerClosed,
                                      ServerConfig, ServerError,
                                      ServerMetrics, ServerOverloaded)
from repro_torch.engine.sim import SimEngine  # noqa: F401
from repro_torch.engine import registry  # noqa: F401
from repro_torch.p2psim.overlay import (Overlay,  # noqa: F401
                                        SessionEvent, apply_events,
                                        available_repairs, get_repair,
                                        random_session, register_repair)

__all__ = ["QuerySpec", "Policy", "TopKResult", "NetworkPlan", "Engine",
           "SimEngine", "DeviceEngine", "QueryServer", "QueryHandle",
           "ServerConfig", "ServerError", "ServerOverloaded", "RequestTimeout",
           "ServerClosed", "ServerMetrics", "LatencyStats", "PhaseStats",
           "Overlay", "SessionEvent", "random_session", "apply_events",
           "available_policies", "get_policy", "policy_from_legacy",
           "register_policy", "register_repair", "get_repair",
           "available_repairs", "registry"]
