"""Overlay simulator host side of the port (topologies and their
registry, the live overlay, parameters, draws, the scalar reference
run, metrics, the retired shims), copied from the reference package.

The engine names the reference's ``repro.p2psim`` re-exports resolve
here too, lazily: ``repro_torch.engine`` imports this package's
modules, so an eager import would be circular."""
from repro_torch.p2psim.graph import (Topology,  # noqa: F401
                                      barabasi_albert, bfs_tree,
                                      eccentricity_ttl, topology_from_arrays,
                                      waxman)
from repro_torch.p2psim.metrics import BatchMetrics, QueryMetrics  # noqa: F401
from repro_torch.p2psim.overlay import (  # noqa: F401
    Overlay, OverlayDelta, SessionEvent, apply_events, available_repairs,
    get_repair, random_session, register_repair)
from repro_torch.p2psim.simulate import (  # noqa: F401
    SimParams, available_placements, build_replica_table, get_placement,
    register_placement, run_queries, run_query, run_query_reference,
    run_statistics_heuristic)
from repro_torch.p2psim.topologies import (  # noqa: F401
    TopologySpec, available_topologies, build_topology, get_topology,
    gnutella, hierarchical, random_regular, register_topology, small_world)

_ENGINE_EXPORTS = ("QuerySpec", "Policy", "TopKResult", "NetworkPlan",
                   "SimEngine", "DeviceEngine", "get_policy",
                   "register_policy", "available_policies",
                   "policy_from_legacy")


def __getattr__(name):
    if name in _ENGINE_EXPORTS:
        import repro_torch.engine as _engine
        return getattr(_engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
