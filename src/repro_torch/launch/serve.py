"""Serving entrypoints of the port: always-on overlay query serving +
LM decode.

``overlay`` — the paper-shaped service: a long-lived
:class:`repro_torch.engine.QueryServer` hosting warm ``SimEngine``
instances (one per requested topology), dynamically batching
concurrent ``QuerySpec`` streams onto shared sweeps on the card and
reporting serving metrics (throughput, latency percentiles, batch
histogram).

  PYTHONPATH=src python -m repro_torch.launch.serve overlay \\
      --topology ba --n-peers 2000 --device cuda \\
      --policies fd-dynamic,cn --requests 256 --concurrency 16

``decode`` — the LM end-to-end path: prefill + decode where every
decode step runs a top-k "query" over the vocabulary, sharded over
``--model-par`` virtual peers, with the FD merge-and-backward (the
top-k and merge kernels on the card).  ``--policy`` selects a member of
the ``repro_torch.engine`` registry (``fd-dynamic`` / ``cn`` /
``cn-star``); the legacy ``--algorithm cn|cn_star`` flag still works.
Random weights from a seed; nothing is downloaded.

  PYTHONPATH=src python -m repro_torch.launch.serve decode \\
      --arch qwen2-0.5b --batch 4 --prompt-len 32 --gen 16 --model-par 16

``--device`` is ``cuda`` by default and raises without a CUDA device;
``--device cpu`` runs the kernels' plain PyTorch versions.  Flag-style
invocations without a subcommand (``... serve --arch ...``) route to
``decode``, as in the reference.
"""
from __future__ import annotations

import argparse
import time


def _require_device(device: str, what: str) -> None:
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"serve {what} --device cuda (the default) needs a CUDA "
            "device and none is available; pass --device cpu to run the "
            "plain PyTorch path")


def state_from_prefill(cfg, prefill_state, s_max: int, cache_dtype=None):
    """Convert prompt-length caches into pre-sized decode caches, cast
    to ``cache_dtype`` (f32 by default): each layer's self-attention
    cache (``KVCache``, or MLA's ``MLACache``) padded with zeros (or
    trimmed) to ``s_max`` along its sequence dim; under a sliding
    window (``cfg.local_window`` = W) a ``WindowKVCache`` of W slots
    holding the prompt's last min(W, prompt) positions at ``pos % W``,
    as the reference's ``conv_window``.  An encoder-decoder's
    ``"cross"`` cache holds the encoder's frames, not the prompt, and is
    kept whole (the reference pads or trims it to ``s_max`` too, so its
    decode attends to other frames).  The recurrent states (RWKV's
    ``state`` / ``xp_t`` / ``xp_c``, the RG-LRU's ``h`` / ``conv``,
    all f32) pass through as they are, as in the reference.

    Under a mesh whose model axis spans ranks (``layers.use_mesh``),
    each attention cache is laid out as ``init_decode_state`` lays it
    (``optim/sharding.py::cache_seq_block``): where its sequence dim
    (S_max, W, the frames) is cut, this rank's block of it for every KV
    head: the block of the prefill's caches where they hold every KV
    head (the heads do not split), else the ranks' KV heads traded for
    sequence blocks over the model ranks in one all-to-all, each KV head
    taken from the first rank that computed it (``attention.kv_spans``;
    ranks whose query heads share a KV head under whole ``w_k`` /
    ``w_v`` both hold it); elsewhere this rank's KV heads over the whole
    sequence, as the prefill left them."""
    import torch

    from repro_torch.core.mesh import all_to_all
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    if cache_dtype is None:
        cache_dtype = torch.float32
    pos = int(prefill_state.pos)
    spans = A.kv_spans(cfg)
    split = {}

    def every_head(a, ax):
        """This rank's sequence block of every KV head from each rank's
        KV heads ``a`` (B, n, nk, Dh), padded to the most any rank
        holds, over one all-to-all."""
        most = max(nk for _, nk in spans)
        a = torch.nn.functional.pad(a, (0, 0, 0, most - a.shape[2]))
        got = all_to_all(a, ax, 1, 2)      # rank r's heads at r * most
        first = [next(r for r, (k0, nk) in enumerate(spans)
                      if k0 <= h < k0 + nk) for h in range(cfg.n_kv_heads)]
        idx = [r * most + h - spans[r][0] for h, r in enumerate(first)]
        if idx == list(range(got.shape[2])):
            return got
        return got.index_select(2, torch.tensor(idx, device=got.device))

    def lay_out(key, a, heads=True):
        """``a`` (B, n, H, Dh), or (B, n, D) without ``heads``, whole over
        its sequence dim of n, in the decode layout."""
        block = L.seq_block(a.shape[1])
        if block is None:
            return a
        split[key] = a.shape[1]
        if heads and spans is not None:
            return every_head(a, block[0])
        return a.narrow(1, block[1], block[2])

    def pad_seq(a):
        cur = a.shape[1]
        if cur >= s_max:
            return a[:, :s_max].to(cache_dtype)
        pad = [0, 0] * (a.dim() - 2) + [0, s_max - cur]
        return torch.nn.functional.pad(a, pad).to(cache_dtype)

    def conv_window(c, w):
        take = min(w, c.k.shape[1], pos)
        lo = max(pos - take, 0)
        dev = c.k.device
        slots = torch.arange(lo, pos, device=dev) % w
        k = c.k.new_zeros((c.k.shape[0], w) + c.k.shape[2:],
                          dtype=cache_dtype)
        v = torch.zeros_like(k)
        pos_slots = torch.full((w,), -1, dtype=torch.int32, device=dev)
        k[:, slots] = c.k[:, lo:pos].to(cache_dtype)
        v[:, slots] = c.v[:, lo:pos].to(cache_dtype)
        pos_slots[slots] = torch.arange(lo, pos, dtype=torch.int32,
                                        device=dev)
        block = L.seq_block(w)
        if block is not None:
            pos_slots = pos_slots.narrow(0, block[1], block[2])
        return A.WindowKVCache(lay_out("self", k), lay_out("self", v),
                               pos_slots)

    def conv(key, c):
        if key == "cross":
            return type(c)(*(lay_out(key, a.to(cache_dtype)) for a in c))
        if key != "self":
            return c
        if isinstance(c, A.KVCache) and cfg.local_window:
            return conv_window(c, cfg.local_window)
        return type(c)(*(lay_out(key, pad_seq(a), isinstance(c, A.KVCache))
                         for a in c))

    caches = [{key: conv(key, c) for key, c in layer.items()}
              for layer in prefill_state.caches]
    return M.DecodeState(caches, prefill_state.pos, split)


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

    _require_device(args.device, "overlay")
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


def _decode_args(argv):
    ap = argparse.ArgumentParser(prog="serve decode")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--model-par", type=int, default=1,
                    help="virtual peers the vocabulary is sharded over")
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--policy", default=None,
                    help="engine policy name (fd-dynamic / cn / cn-star; "
                         "see repro_torch.engine); overrides --algorithm")
    ap.add_argument("--algorithm", default="fd",
                    choices=("fd", "cn", "cn_star"),
                    help="legacy algorithm flag (mapped onto a policy)")
    ap.add_argument("--schedule", default="halving",
                    choices=("halving", "doubling", "ring"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model and the sampling run; cuda "
                         "raises without a CUDA device")
    ap.add_argument("--ranks", type=int, default=1,
                    help="gloo ranks to decode over (one process: 1)")
    ap.add_argument("--model-ranks", type=int, default=None,
                    help="ranks the model axis spans (default: the "
                         "reference's clamp of --model-par to --ranks)")
    return ap.parse_args(argv)


def decode_run(argv=None, *, group=None, data=None, dtype=None,
               changes=None) -> dict:
    """The decode of ``main_decode`` without its lines: {"tokens" (batch,
    gen) numpy, "cfg", "policy", "t_prefill", "t_decode", "mesh",
    "params" (this rank's blocks), "state" (the decode state after the
    last step, this rank's rows and blocks)}.  A rank of a group passes
    its ``group``: it decodes its rows of the batch and gets the whole
    batch's tokens back.  On one process, ``data`` virtual data peers
    split the batch as the data ranks do (MoE then dispatches per data
    shard), to compare with the ranks.  ``dtype`` (e.g. ``"float32"``)
    replaces the config's parameter and compute dtypes, ``changes``
    (e.g. ``{"n_layers": 2}``) other fields of the config."""
    args = _decode_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.data.pipeline import device_put_batch, \
        extra_model_inputs
    from repro_torch.engine import get_policy, policy_from_legacy
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.launch.train import place_blocks
    from repro_torch.optim.sharding import batch_axes, gather_leaf, _entry
    from repro_torch.runtime.steps import make_serve_step

    _require_device(args.device, "decode")
    try:
        pol = (get_policy(args.policy) if args.policy
               else policy_from_legacy(args.algorithm))
    except KeyError as e:
        raise SystemExit(f"--policy: {e.args[0]}")
    if pol.algorithm not in ("fd", "cn", "cn_star"):
        raise SystemExit(f"policy {pol.name!r} has no device backend")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if dtype is not None or changes:
        import dataclasses
        if dtype is not None:
            changes = dict(changes or {}, param_dtype=dtype,
                           compute_dtype=dtype)
        cfg = dataclasses.replace(cfg, **changes)
    device = torch.device(args.device)
    if group is not None and device.type == "cuda":
        import torch.distributed as dist
        device = torch.device("cuda", dist.get_rank(group)
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = make_host_mesh(model=args.model_par, device=device, cfg=cfg,
                          group=group, data=data,
                          model_ranks=args.model_ranks)
    if mesh.multi_rank and args.batch % mesh.shape["data"]:
        raise ValueError(f"a batch of {args.batch} does not split over "
                         f"{mesh.shape['data']} data peers")
    s_max = args.prompt_len + args.gen

    params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                           max_seq=s_max, device=device)
    if mesh.multi_rank:                 # this rank's model blocks
        place_blocks(params, cfg, mesh, axes=("model",))

    rng = np.random.default_rng(0)
    batch_np = {"tokens": rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)}
    batch = extra_model_inputs(cfg, batch_np)
    batch = device_put_batch(batch, mesh)     # this rank's rows
    serve_step = make_serve_step(cfg, mesh, k=args.k,
                                 algorithm=pol.algorithm,
                                 schedule=args.schedule)
    if device.type == "cuda":
        _build.ensure_built()           # the kernels' one-time build

    t0 = time.perf_counter()
    with L.use_mesh(mesh):
        last_logits, pstate = M.prefill(params, cfg, batch)
        state = state_from_prefill(cfg, pstate, s_max)
        tok = M.argmax_vocab(last_logits, cfg)[:, None].to(torch.int32)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_prefill = time.perf_counter() - t0

    out_tokens = [tok]
    gen = torch.Generator(device).manual_seed(1)
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        tok, state = serve_step(params, state, tok, gen)
        out_tokens.append(tok)
    toks = torch.cat(out_tokens, dim=1)
    if mesh.multi_rank:                 # every data rank's rows
        toks = gather_leaf(toks, (_entry(batch_axes(mesh.shape)), None),
                           mesh)
    toks = toks.cpu().numpy()
    t_decode = time.perf_counter() - t0
    return {"tokens": toks, "cfg": cfg, "policy": pol.name,
            "t_prefill": t_prefill, "t_decode": t_decode, "mesh": mesh,
            "params": params, "state": state}


def _decode_rank(rank: int, world: int, argv) -> dict:
    """What each rank of ``serve decode --ranks`` runs."""
    import torch.distributed as dist

    from repro_torch.launch.train import _share_cores
    _share_cores(world)
    out = decode_run(argv, group=dist.group.WORLD)
    del out["params"], out["state"]
    out["sent_bytes"] = out.pop("mesh").sent_bytes
    out["name"] = out.pop("cfg").name
    return out


def main_decode(argv=None):
    """LM prefill + decode driver (FD top-k sampling each step); prints
    the reference's two lines and returns the tokens (batch, gen).

    ``--ranks R`` decodes over R gloo ranks (``launch/ranks.py``): the
    mesh ``(data, model)`` of ``launch/mesh.py::make_host_mesh`` over
    the ranks, each rank holding the model block of every leaf (whole
    over the data axes; ``--model-ranks`` sets how many ranks the model
    axis spans) and its data rows of the batch and of the decode state
    (the batch entry of ``optim/sharding.py::decode_state_specs``: each
    data rank prefills its own rows), the products split over the model
    ranks (attention heads, FFN columns, experts, the vocabulary block;
    ``models/layers.py``), the ``--model-par`` peers of the vocabulary
    spread over the model ranks, the FD top-k across them
    (``core/fd.py``), MoE dispatched per data shard as the reference
    does.  Each attention cache's sequence dim (S_max, the window, the
    encoder's frames), which ``decode_state_specs`` puts over
    ``model``, is cut over the model ranks where it divides the model
    size: the rank holds its block for every KV head, and the
    attention's softmax and its product with V are reduced over the
    model ranks (``models/attention.py``); elsewhere a cache holds the
    rank's KV heads over the whole sequence.  Rank 0 prints."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _decode_args(argv)
    if args.ranks > 1:
        from repro_torch.launch.ranks import RANK_TIMEOUT_S, spawn_ranks
        _require_device(args.device, "decode")
        if args.device == "cuda":
            from repro_torch.kernels import _build
            _build.ensure_built()       # the ranks load the built kernels
        out = spawn_ranks(_decode_rank, args.ranks, args=(argv,),
                          timeout=RANK_TIMEOUT_S)[0]
    else:
        out = decode_run(argv)
        out["name"] = out["cfg"].name
    name = out["name"]
    toks = out["tokens"]
    t_decode = out["t_decode"]
    print(f"arch={name} policy={out['policy']} "
          f"prefill {args.prompt_len} tok in {out['t_prefill']:.2f}s; "
          f"decoded {args.gen - 1} steps in {t_decode:.2f}s "
          f"({(args.gen - 1) * args.batch / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample tokens:", toks[0, :12].tolist())
    return toks


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
