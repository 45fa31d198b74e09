"""What each gloo rank of chip_smoke.py's phase 15 runs on the card.

Not a script: ``chip_smoke.py`` spawns the ranks with
``repro_torch.launch.ranks.spawn_ranks(chip_ranks.run, 4, args=(conf,))``
after building the kernels, and every rank imports this module by
name.  Each rank runs on ``cuda:0`` (one card, shared by the ranks'
processes; the ranks talk over gloo) and returns plain numbers; a
failed check raises.  ``tests/test_torch_ranks.py`` runs the same
checks on the CPU path at a small size (``conf["device"] = "cpu"``).

(a) the ``DeviceEngine`` over the ranks at phase 5's full width: 64
    peers as 4 ranks x 16 local peers, N = 64 x 20,000 f32 scores, 32
    stacked queries at k = 20 under every schedule, the row gather, CN,
    CN*, 4 queries at k = 512 (the top-k's select route), and a (2, 64)
    data x model mesh laid out (2, 2) over the ranks with
    ``batch_axes=("data",)``; each rank's answers equal, bit for bit,
    the one-process engine's on the card, rank r's the row r * L of
    ``fd._peer_lists``; the top-k, select and merge counters moved;
(b) the compressed gradient mean over the 4 ranks as pods at
    qwen2-0.5b's full parameter tree (f32 gradients: a shared part and
    each rank's own noise), ``k_frac`` 1e-3 and ``p_drop`` 0.05, two
    rounds, the second of zero gradients; each rank's ``g_hat`` and
    error feedback equal, bit for bit, the same computation with
    ``topk_ref`` on the card, every rank's ``g_hat`` is the same (a
    64-bit digest of each leaf's bits), and the embedding leaf's sum of
    the gathered lists equals the CPU's sum in pod order.
"""
import time

import torch
import torch.distributed as dist


def _same(a, b):
    """Equal shapes and bits."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a = a.contiguous().view(bits[a.element_size()])
        b = b.contiguous().view(bits[b.element_size()])
    return bool(torch.equal(a, b))


def _require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _digest(t) -> int:
    """A 64-bit digest of a tensor's bits (position-weighted, wrapping
    int64 sums)."""
    bits = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    w = torch.arange(bits.numel(), device=t.device, dtype=torch.int64)
    return int(((bits + 0x9E3779B9) * (w * 2 + 1)).sum())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _launched(dev, counts, names, what):
    """Every kernel of ``names`` launched (on the card; the CPU path
    launches none)."""
    for name in names:
        _require(dev.type != "cuda" or counts[name] > 0,
                 f"{what}: kernel {name} never launched")


def run(rank: int, world: int, conf: dict) -> dict:
    """Phase 15 on this rank: (a) then (b), on ``conf["device"]``
    (the card; the CPU runs the same checks at a small ``conf``)."""
    dev = torch.device(conf.get("device", "cuda"))
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        from repro_torch.kernels import _build
        _build.ensure_built()
    t0 = time.perf_counter()
    out = {"device": _device_path(rank, world, conf, dev)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["compress"] = _compress(rank, world, conf, dev)
    out["seconds"] = time.perf_counter() - t0
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def _device_path(rank, world, conf, dev):
    from repro_torch import DeviceEngine, make_mesh
    from repro_torch.core import fd
    from repro_torch.engine import QuerySpec
    from repro_torch.kernels import _build
    P, NL, K, B = conf["peers"], conf["local"], conf["k"], conf["batch"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(conf["seed"])
    n = P * NL
    scores = torch.randn((B, n), generator=gen, device=dev)
    rows = torch.randn((n, conf["d"]), generator=gen, device=dev)
    group = dist.group.WORLD
    mesh = make_mesh((P,), ("model",), group=group, device=dev)
    ax = mesh.axis("model")
    nb = n // ax.ranks
    blk = scores[:, ax.index * nb:(ax.index + 1) * nb].contiguous()
    rblk = rows[ax.index * nb:(ax.index + 1) * nb].contiguous()
    m22 = make_mesh((2, P), ("data", "model"), group=group, ranks=(2, 2),
                    device=dev)
    ax22 = m22.axis("model")
    nb22 = n // ax22.ranks
    blk22 = scores[:, ax22.index * nb22:(ax22.index + 1) * nb22].contiguous()
    spec = QuerySpec(k=K)
    schedules = ("halving", "doubling", "ring")
    runs = [(sch, "fd-dynamic", DeviceEngine(mesh, schedule=sch))
            for sch in schedules]
    cn_eng = DeviceEngine(mesh)
    runs += [("-", "cn", cn_eng), ("-", "cn-star", cn_eng)]
    eng22 = {sch: DeviceEngine(m22, schedule=sch, batch_axes=("data",))
             for sch in schedules}
    large_spec = QuerySpec(k=conf["k_large"])
    _sync(dev)
    dist.barrier()
    # the main path, counted alone
    _build.reset_launches()
    t0 = time.perf_counter()
    res, got, run_s, sent = {}, {}, {}, {}

    def call(key, fn):
        """Two calls (the first builds the rounds): run_s of each, the
        bytes of the second."""
        for rep in range(2):
            out = fn()
            first = out[0] if isinstance(out, list) else out
            run_s[f"{key}#{rep}"] = first.run_s
        sent[key] = first.extras["sent_bytes"]
        return out

    for sch, pol, eng in runs:
        res[(sch, pol)] = call(f"{pol}/{sch}/run_many", lambda: eng.run_many(
            [spec] * B, pol, scores=list(blk)))
        if pol == "fd-dynamic":
            got[sch] = call(f"{pol}/{sch}/gather", lambda: eng.run(
                spec, pol, scores=blk, rows=rblk))
    large = call(f"fd-dynamic/halving/run_many k={conf['k_large']}",
                 lambda: runs[0][2].run_many([large_spec] * 4, "fd-dynamic",
                                             scores=list(blk[:4])))
    res22 = {}
    for sch in schedules:
        res22[sch] = call(f"fd-dynamic/{sch}/run_many (2, 2)",
                          lambda: eng22[sch].run_many(
                              [spec] * B, "fd-dynamic", scores=list(blk22)))
    _sync(dev)
    path_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    _launched(dev, launches, ("topk", "topk_select", "merge"),
              f"rank {rank}'s device path")

    # the one-process engine on the card, bit for bit
    one = make_mesh((P,), ("model",), device=dev)
    local = scores.view(B, P, NL)

    def stack(rs, field):
        return torch.stack([getattr(r, field) for r in rs])

    for (sch, pol), rs in res.items():
        _require(all(r.batch_size == B and r.backend == "device-torch"
                     for r in rs), f"{pol}/{sch}: requests not stacked")
        v, i = stack(rs, "values"), stack(rs, "indices")
        if pol == "fd-dynamic":
            lv, li = fd._peer_lists(local, K, sch, None)
            _require(_same(v, lv[:, ax.offset])
                     and _same(i, li[:, ax.offset]),
                     f"{pol}/{sch} rank {rank}: != the one-process row "
                     f"{ax.offset}")
            w = DeviceEngine(one, schedule=sch).run(spec, pol,
                                                    scores=scores,
                                                    rows=rows)
            g = got[sch]
            _require(_same(g.values, w.values) and _same(g.rows, w.rows)
                     and _same(g.indices, li[:, ax.offset]),
                     f"{pol}/{sch} gather rank {rank}: != one process")
            if sch == "halving":
                _require(_same(i, w.indices), "halving: indices differ "
                         "from the one-process engine's")
        else:
            w = DeviceEngine(one).run_many([spec] * B, pol,
                                           scores=list(scores))
            _require(_same(v, stack(w, "values"))
                     and _same(i, stack(w, "indices")),
                     f"{pol} rank {rank}: != the one-process engine")
    w = DeviceEngine(one).run_many([large_spec] * 4, "fd-dynamic",
                                   scores=list(scores[:4]))
    _require(_same(stack(large, "values"), stack(w, "values"))
             and _same(stack(large, "indices"), stack(w, "indices")),
             f"k={conf['k_large']} rank {rank}: != the one-process engine")
    for sch in schedules:
        lv, li = fd._peer_lists(local, K, sch, None)
        row = ax22.index * ax22.local
        _require(_same(stack(res22[sch], "values"), lv[:, row])
                 and _same(stack(res22[sch], "indices"), li[:, row]),
                 f"(2, 2) {sch} rank {rank}: != the one-process row {row}")
    return {"launches": launches, "run_s": run_s, "sent_bytes": sent,
            "path_s": path_s, "L": ax.local}


def _tree(leaves):
    """A nested dict from dotted names."""
    tree = {}
    for name, t in leaves:
        *path, last = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = t
    return tree


def _flat(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _in_turns(rank, world, fn, dev):
    """``fn`` run by one rank at a time (its scratch is large), every
    rank calling it alike."""
    def call(*args, **kw):
        out = None
        for turn in range(world):
            if turn == rank:
                out = fn(*args, **kw)
                _sync(dev)
            dist.barrier()
        return out
    return call


def _compress(rank, world, conf, dev):
    from repro_torch import make_mesh
    from repro_torch.core import mesh as M
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk import topk_ref
    from repro_torch.optim import compress as C
    shared = torch.Generator(device=dev)
    shared.manual_seed(conf["seed"] + 100)
    own = torch.Generator(device=dev)
    own.manual_seed(conf["seed"] + 101 + rank)
    leaves = []
    for name, shape in conf["leaves"]:
        g = torch.randn(shape, generator=shared, device=dev)
        g.add_(torch.randn(shape, generator=own, device=dev),
               alpha=conf["noise"])
        leaves.append((name, g))
    grads = _tree(leaves)
    del leaves
    mesh = make_mesh((world,), ("pod",), group=dist.group.WORLD,
                     device=dev)
    kw = dict(axis="pod", k_frac=conf["k_frac"], p_drop=conf["p_drop"])
    state0 = C.compress_init(grads)
    ks = {name: C.inflate_k(max(1, int(conf["k_frac"] * g.numel())),
                            conf["p_drop"]) for name, g in _flat(grads)}
    numel = {name: g.numel() for name, g in _flat(grads)}
    out = {"launches": [], "seconds": [], "sent_bytes": [], "digests": [],
           "n": sum(numel.values()), "leaves": len(numel),
           "k": sum(ks.values())}

    def round_(grads, state):
        _sync(dev)
        dist.barrier()
        _build.reset_launches()
        sent0, t0 = mesh.sent_bytes, time.perf_counter()
        g_hat, new = C.fd_sparse_allreduce(grads, state, mesh, **kw)
        _sync(dev)
        out["seconds"].append(time.perf_counter() - t0)
        out["sent_bytes"].append(mesh.sent_bytes - sent0)
        out["launches"].append(dict(_build.LAUNCHES))
        _launched(dev, _build.LAUNCHES, ("topk", "topk_select"),
                  f"rank {rank}'s compressed mean")
        out["digests"].append([_digest(g) for _, g in _flat(g_hat)])
        return g_hat, new

    def check(what, grads, state, g_hat, new):
        """Leaf by leaf, the same computation with topk_ref."""
        kernel = C.local_topk
        C.local_topk = _in_turns(rank, world, lambda x, k: topk_ref(x, k),
                                 dev)
        try:
            hats, efs = dict(_flat(g_hat)), dict(_flat(new.ef))
            for (name, g), (_, ef) in zip(_flat(grads), _flat(state.ef)):
                rh, rs = C.fd_sparse_allreduce(
                    {"x": g}, C.CompressState({"x": ef}), mesh, **kw)
                _require(_same(hats[name], rh["x"])
                         and _same(efs[name], rs.ef["x"]),
                         f"{what} rank {rank} {name}: g_hat or ef != the "
                         "computation with topk_ref")
                del rh, rs
        finally:
            C.local_topk = kernel

    g_hat1, state1 = round_(grads, state0)
    check("round 1", grads, state0, g_hat1, state1)
    # the embedding leaf: the gathered lists, how many pods chose each
    # index, and their sum in pod order on the card == on the CPU
    name = max(numel, key=numel.get)
    g, ef = dict(_flat(grads))[name], dict(_flat(state0.ef))[name]
    vals, idx, _ = C.topk_sparsify(g, ks[name], ef)
    all_v = M.gather_dim(vals[None], mesh.axis("pod"), 0)
    all_i = M.gather_dim(idx[None], mesh.axis("pod"), 0)
    _, chosen = torch.unique(all_i, return_counts=True)
    out["three_or_more"] = int((chosen >= 3).sum())
    out["embedding"] = {"name": name, "shape": list(g.shape),
                        "k": ks[name]}
    if rank == 0:
        cpu = C._sparse_sum(all_v.cpu(), all_i.cpu(), g.numel()) / world
        _require(_same(cpu.reshape(g.shape),
                       dict(_flat(g_hat1))[name].cpu()),
                 f"{name}: the card's sum in pod order != the CPU's")
    _require(out["three_or_more"] > 0, f"{name}: no index chosen by three "
             "or more pods")
    del grads, g_hat1, g, ef, vals, idx, all_v, all_i, chosen, state0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    zeros = _tree((n, torch.zeros(t.shape, device=dev))
                  for n, t in _flat(state1.ef))
    g_hat2, state2 = round_(zeros, state1)
    check("round 2", zeros, state1, g_hat2, state2)
    ef1 = sum(float(e.abs().sum()) for _, e in _flat(state1.ef))
    ef2 = sum(float(e.abs().sum()) for _, e in _flat(state2.ef))
    _require(ef2 < ef1, f"round 2 did not drain the error feedback: "
             f"{ef1} -> {ef2}")
    out["ef_l1"] = [ef1, ef2]
    out["dense_bytes"] = sum(4 * n * 2 * (world - 1) / world
                             for n in numel.values())
    out["list_bytes"] = sum(8 * k * (world - 1) for k in ks.values())
    return out
