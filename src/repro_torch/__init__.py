"""PyTorch / CUDA port of the FD top-k overlay query engine.

A second package beside the JAX reference (``repro``): it imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.  The host
side (overlay, plan, RNG draws, epilogue, serving) is a copy of the
reference's numpy code; the sweep runs in PyTorch on a CUDA device
through the hand-written kernels of :mod:`repro_torch.kernels`.

    from repro_torch.engine import QuerySpec, SimEngine
    from repro_torch.p2psim import SimParams, barabasi_albert

    engine = SimEngine(barabasi_albert(100_000, m=2, seed=7),
                       SimParams(seed=5))          # device="cuda"
    res = engine.run(QuerySpec(origins=(0,)), "fd-dynamic")

The reference's engine names resolve on the package itself
(``repro_torch.SimEngine``, ``repro_torch.QueryServer``, ...).

The FD collectives run on a mesh of virtual peers held on one device
(``DeviceEngine`` over ``make_mesh``), through the hand-written top-k
and merge kernels (``local_topk`` is the top-k's public entry):

    from repro_torch import DeviceEngine, make_mesh
    from repro_torch.engine import QuerySpec

    engine = DeviceEngine(make_mesh((64,), ("model",)))   # on "cuda"
    res = engine.run(QuerySpec(k=20), "fd-dynamic", scores=scores)
"""
from repro_torch.core.mesh import make_mesh  # noqa: F401
from repro_torch.engine.device import DeviceEngine  # noqa: F401
from repro_torch.kernels.topk import local_topk  # noqa: F401

# the reference's engine surface, one import path for the query API:
# repro_torch.SimEngine, repro_torch.QuerySpec, ... resolve lazily from
# repro_torch.engine, as the reference's names do from repro.engine
_ENGINE_EXPORTS = ("QuerySpec", "Policy", "TopKResult", "NetworkPlan",
                   "Engine", "SimEngine", "DeviceEngine", "QueryServer",
                   "ServerConfig", "get_policy", "register_policy",
                   "available_policies", "policy_from_legacy")

__all__ = ["make_mesh", "local_topk", *_ENGINE_EXPORTS]


def __getattr__(name):
    if name in _ENGINE_EXPORTS:
        import repro_torch.engine as _engine
        return getattr(_engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
