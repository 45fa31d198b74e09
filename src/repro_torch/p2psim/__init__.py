"""Overlay simulator host side of the port (topologies and their
registry, the live overlay, parameters, draws, the scalar reference
run, metrics), copied from the reference package."""
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
    register_placement, run_query_reference)
from repro_torch.p2psim.topologies import (  # noqa: F401
    TopologySpec, available_topologies, build_topology, get_topology,
    gnutella, hierarchical, random_regular, register_topology, small_world)
