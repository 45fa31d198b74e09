"""Serving entrypoint of the port: always-on overlay query serving.

``overlay`` — the paper-shaped service: a long-lived
:class:`repro_torch.engine.QueryServer` hosting warm ``SimEngine``
instances (one per requested topology), dynamically batching
concurrent ``QuerySpec`` streams onto shared sweeps on the card and
reporting serving metrics (throughput, latency percentiles, batch
histogram).

  PYTHONPATH=src python -m repro_torch.launch.serve overlay \\
      --topology ba --n-peers 2000 --device cuda \\
      --policies fd-dynamic,cn --requests 256 --concurrency 16

``--device`` is ``cuda`` by default and raises without a CUDA device;
``--device cpu`` runs the kernels' plain PyTorch versions.

``decode`` — the reference's LM prefill + decode path — is not ported
yet: it, and the flag-style invocation that routes to it, exit with a
message saying so.
"""
from __future__ import annotations

import argparse
import time

_DECODE_MISSING = (
    "serve decode: the LM decode path (models, runtime.steps, "
    "launch.mesh) is not ported to repro_torch yet; run it from the "
    "reference package (python -m repro.launch.serve decode ...)")


def main_overlay(argv=None):
    """Run a QueryServer over warm overlay engines and drive it with a
    closed-loop client pool; prints and returns the serving metrics."""
    import threading

    import numpy as np

    ap = argparse.ArgumentParser(prog="serve overlay")
    ap.add_argument("--topology", default="ba",
                    help="comma list of registered topology families "
                         "(one warm engine per entry)")
    ap.add_argument("--n-peers", type=int, default=1000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the sweeps run; cuda raises without a "
                         "CUDA device")
    ap.add_argument("--policies", default="fd-dynamic,cn",
                    help="comma list of engine policy names, assigned "
                         "round-robin to requests")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--concurrency", type=int, default=16,
                    help="closed-loop client threads")
    ap.add_argument("--n-trials", type=int, default=1)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument("--timeout-s", type=float, default=None)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.engine import (QueryServer, QuerySpec, ServerConfig,
                                    SimEngine)
    from repro_torch.engine.serve import ServerError
    from repro_torch.p2psim import SimParams, build_topology

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "serve overlay --device cuda (the default) needs a CUDA "
            "device and none is available; pass --device cpu to run the "
            "plain PyTorch path")
    device = torch.device(args.device)
    params = SimParams(k=args.k)
    engines = {}
    for fam in args.topology.split(","):
        fam = fam.strip()
        topo = build_topology(fam, args.n_peers, seed=args.seed)
        engines[fam] = SimEngine(topo, params=params, device=device)
    policies = [p.strip() for p in args.policies.split(",")]
    names = sorted(engines)
    server = QueryServer(engines, ServerConfig(
        max_queue=args.max_queue, max_batch=args.max_batch,
        batch_window_s=args.batch_window_ms / 1e3,
        default_timeout_s=args.timeout_s))
    for name in names:      # populate plan / kernel caches before load
        server.warm(QuerySpec(origins=(0,), seed=args.seed),
                    policies[0], engine=name)

    rng = np.random.default_rng(args.seed)
    reqs = [(QuerySpec(origins=(int(rng.integers(args.n_peers)),),
                       n_trials=args.n_trials,
                       seed=int(rng.integers(1 << 30))),
             policies[i % len(policies)], names[i % len(names)])
            for i in range(args.requests)]
    cursor = {"i": 0}
    lock = threading.Lock()
    errors = []

    def client():
        while True:
            with lock:
                i = cursor["i"]
                if i >= len(reqs):
                    return
                cursor["i"] = i + 1
            spec, pol, name = reqs[i]
            try:
                server.query(spec, pol, engine=name)
            except ServerError as e:     # shed/timeout: counted, not fatal
                errors.append(e)

    with server:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client)
                   for _ in range(args.concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        m = server.metrics()
    qps = m.served / max(wall, 1e-9)
    print(f"served {m.served}/{args.requests} requests over "
          f"{len(engines)} engine(s) [{device}] in {wall:.2f}s "
          f"({qps:.1f} qps); shed {m.shed}, timed out {m.timed_out}")
    if m.latency is not None:
        print("latency p50/p95/p99 = "
              f"{m.latency.p50_s * 1e3:.2f}/{m.latency.p95_s * 1e3:.2f}/"
              f"{m.latency.p99_s * 1e3:.2f} ms; mean batch "
              f"{m.mean_batch:.2f} (max {m.max_batch})")
    metrics = m.as_dict()
    metrics["wall_s"] = wall
    metrics["throughput_qps"] = qps
    return metrics


def main_decode(argv=None):
    """The reference's LM prefill + decode driver: not ported yet, so
    it exits with a message instead of decoding."""
    raise SystemExit(_DECODE_MISSING)


def main(argv=None):
    """Dispatch ``overlay`` / ``decode``; bare flags route to decode."""
    import sys
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "overlay":
        return main_overlay(argv[1:])
    if argv and argv[0] == "decode":
        return main_decode(argv[1:])
    return main_decode(argv)            # legacy flag-style invocation


if __name__ == "__main__":
    main()
