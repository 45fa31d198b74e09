"""Overlay simulator host side of the port (topologies, parameters,
draws, metrics), copied from the reference package."""
from repro_torch.p2psim.graph import (Topology,  # noqa: F401
                                      barabasi_albert, topology_from_arrays)
from repro_torch.p2psim.metrics import BatchMetrics, QueryMetrics  # noqa: F401
from repro_torch.p2psim.simulate import (  # noqa: F401
    SimParams, available_placements, build_replica_table, get_placement,
    register_placement)
