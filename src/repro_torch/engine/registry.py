"""One surface over every name registry the port exposes.

A copy of the reference package's ``engine.registry``.  Four registries
follow the same ``register_* / get_* / available_*`` idiom; this module
re-exports them so callers (and ``QuerySpec``-style string configs)
resolve every kind of name through one import:

  * **policies** (``repro_torch.engine.api``) — query-execution policies
    ("fd-dynamic", "cn", ...) run by the engines;
  * **topologies** (``repro_torch.p2psim.topologies``) — overlay
    generators ("ba", "waxman", "hierarchical", ...);
  * **repairs** (``repro_torch.p2psim.overlay``) — overlay self-healing
    policies ("none", "reconnect") run by ``Overlay.remove_peer``;
  * **placements** (``repro_torch.p2psim.simulate``) — replica placement
    policies ("random", "neighbor") named by
    ``SimParams.replication_placement``.

    from repro_torch.engine import registry
    registry.get_repair("reconnect")
    registry.available_placements()          # ('neighbor', 'random')
"""
from repro_torch.engine.api import (available_policies,  # noqa: F401
                                    get_policy, register_policy)
from repro_torch.p2psim.overlay import (available_repairs,  # noqa: F401
                                        get_repair, register_repair)
from repro_torch.p2psim.simulate import (  # noqa: F401
    available_placements, get_placement, register_placement)
from repro_torch.p2psim.topologies import (  # noqa: F401
    available_topologies, get_topology, register_topology)

__all__ = [
    "register_policy", "get_policy", "available_policies",
    "register_topology", "get_topology", "available_topologies",
    "register_repair", "get_repair", "available_repairs",
    "register_placement", "get_placement", "available_placements",
]
