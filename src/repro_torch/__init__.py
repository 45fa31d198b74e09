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
"""
