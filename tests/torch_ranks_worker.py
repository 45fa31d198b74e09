"""What each gloo rank of ``tests/test_torch_ranks.py`` runs.

A module of its own (torch, numpy and the port only, no JAX): the
ranks are spawned processes that import their function by name.
``run(rank, world, inp)`` takes the test's numpy inputs, runs the
port's FD collectives, ``DeviceEngine`` and gradient compression on
this rank's blocks of them over meshes that span the ``world`` ranks,
and returns numpy outputs (and the errors each refused call raised)
for the test to hold against the reference and the one-process mesh.
"""
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import fd, mesh as M
from repro_torch.engine import DeviceEngine, QuerySpec
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import compress as C

SCHEDULES = ("halving", "doubling", "ring")
K = 20
K2 = 6
#: the (data, model) rank layouts of the (2, 4) mesh, by world size
LAYOUTS = {2: ((2, 1), (1, 2)), 4: ((2, 2), (1, 4))}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(out):
    return tuple(t.numpy() if isinstance(t, torch.Tensor) else t
                 for t in out)


def _block(a, ax, dim=-1):
    """This rank's block of ``a`` along ``dim`` for mesh axis ``ax``."""
    n = a.shape[dim] // ax.ranks
    return a.narrow(dim, ax.index * n, n)


def _refused(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def run(rank: int, world: int, inp: dict) -> dict:
    group = dist.group.WORLD
    out, bytes_, errors = {}, {}, {}
    m8 = M.make_mesh((8,), ("model",), device="cpu", group=group)
    ax8 = m8.axis("model")
    rows = _t(inp["rows"])
    for name in ("normal", "tied"):
        s = _t(inp[name])
        for sch in SCHEDULES:
            out[f"fd/{name}/{sch}"] = _np(fd.fd_topk(
                _block(s, ax8), K, m8, schedule=sch))
            out[f"gather/{name}/{sch}"] = _np(fd.fd_topk_gather(
                _block(s, ax8), _block(rows, ax8, 0), K, m8, schedule=sch))
        for alg in ("cn", "cn_star"):
            out[f"{alg}/{name}"] = _np(fd.fd_topk(_block(s, ax8), K, m8,
                                                  algorithm=alg))
    out["gather1"] = _np(fd.fd_topk_gather(
        _block(_t(inp["normal"][0]), ax8), _block(rows, ax8, 0), 4, m8))

    for lay in LAYOUTS[world]:
        m24 = M.make_mesh((2, 4), ("data", "model"), device="cpu",
                          group=group, ranks=lay)
        axm = m24.axis("model")
        rows2 = _block(_t(inp["rows2"]), axm, 0)
        for name in ("normal", "tied"):
            s2 = _block(_t(inp[name + "2"]), axm)
            for sch in SCHEDULES:
                out[f"fd24/{lay}/{name}/{sch}"] = _np(fd.fd_topk(
                    s2, K2, m24, schedule=sch, batch_axes=("data",)))
            for alg in ("cn", "cn_star"):
                out[f"{alg}24/{lay}/{name}"] = _np(fd.fd_topk(
                    s2, K2, m24, algorithm=alg, batch_axes=("data",)))
            out[f"gather24/{lay}/{name}"] = _np(fd.fd_topk_gather(
                s2, rows2, K2, m24, batch_axes=("data",)))
        res = DeviceEngine(m24, batch_axes=("data",), schedule="ring").run(
            QuerySpec(k=K2), "fd-dynamic",
            scores=_block(_t(inp["tied2"]), axm))
        out[f"eng24/{lay}"] = _np((res.values, res.indices))

    spec = QuerySpec(k=K)
    normal = _block(_t(inp["normal"]), ax8)
    for sch in SCHEDULES:
        eng = DeviceEngine(m8, schedule=sch)
        res = eng.run(spec, "fd-dynamic", scores=normal,
                      rows=_block(rows, ax8, 0))
        again = eng.run(spec, "fd-dynamic", scores=normal,
                        rows=_block(rows, ax8, 0))
        out[f"eng/{sch}"] = _np((res.values, res.indices, res.rows,
                                 res.extras["model_bytes"],
                                 res.backend, again.compile_s,
                                 again.values))
    eng = DeviceEngine(m8)
    tied = _block(_t(inp["tied"]), ax8)
    for pol in ("cn", "cn-star"):
        res = eng.run(spec, pol, scores=tied)
        out[f"eng/{pol}"] = _np((res.values, res.indices,
                                 res.extras["model_bytes"]))
    pols = ["fd-dynamic", "fd-basic", "cn", "fd-st1"]
    many = [_block(_t(a), ax8) for a in inp["many"]]
    for b, res in enumerate(eng.run_many([spec] * 4, pols, scores=many)):
        out[f"many/{b}"] = _np((res.values, res.indices, res.batch_size))

    # the bytes delivered to other ranks at one peer a rank, one query
    mp = M.make_mesh((world,), ("model",), device="cpu", group=group)
    one = _block(_t(inp["normal"][0]), mp.axis("model"))
    for alg, sch in ([("fd", s) for s in SCHEDULES]
                     + [("cn", "-"), ("cn_star", "-")]):
        before = mp.sent_bytes
        fd.fd_topk(one, 5, mp, algorithm=alg,
                   schedule="halving" if sch == "-" else sch)
        bytes_[f"{alg}/{sch}"] = mp.sent_bytes - before
    bytes_["n_local"] = one.shape[-1]

    # gradient compression: 4 pods of their own gradients over the ranks
    pods = M.make_mesh((4,), ("pod",), device="cpu", group=group)
    axp = pods.axis("pod")
    g_hat, new_ef = C.fd_sparse_allreduce_shard(
        _block(_t(inp["pod_g"]), axp, 0), _block(_t(inp["pod_ef"]), axp, 0),
        k=int(inp["pod_k"]), axis=axp)
    out["shard"] = _np((g_hat, new_ef))
    # the tree-wise mean of replicated gradients, two rounds
    pods8 = M.make_mesh((8,), ("pod",), device="cpu", group=group)
    tree = {"w": _t(inp["tree_w"]), "b": {"v": _t(inp["tree_b"])}}
    state = C.compress_init(tree)
    for rnd in range(2):
        g_hat, state = C.fd_sparse_allreduce(
            tree, state, pods8, axis="pod", k_frac=0.05, p_drop=0.05)
        out[f"tree/{rnd}"] = _np((g_hat["w"], g_hat["b"]["v"],
                                  state.ef["w"], state.ef["b"]["v"]))
        tree = {"w": torch.zeros_like(tree["w"]),
                "b": {"v": torch.zeros_like(tree["b"]["v"])}}

    prod = make_production_mesh(device="cpu", group=group)
    out["production"] = (dict(prod.shape), prod.axis_names,
                         dict(prod.ranks))

    # refused on every rank before any collective, the group intact
    errors["block"] = _refused(lambda: fd.fd_topk(
        torch.zeros(1004 // world), 4, m8))
    errors["rows"] = _refused(lambda: fd.fd_topk_gather(
        torch.zeros(1024 // world), torch.zeros(8, 2), 4, m8))
    errors["k"] = _refused(lambda: fd.fd_topk(
        torch.zeros(1024 // world), 200, m8))
    errors["ranks"] = _refused(lambda: M.make_mesh(
        (5,), ("model",), device="cpu", group=group))
    errors["layout"] = _refused(lambda: M.make_mesh(
        (2, 4), ("data", "model"), device="cpu", group=group, ranks=(1, 1)))
    errors["production"] = _refused(lambda: make_production_mesh(
        multi_pod=True, device="cpu", group=group))
    odd = M.make_mesh((3 * world,), ("model",), device="cpu", group=group)
    errors["halving"] = _refused(lambda: fd.fd_topk(
        torch.zeros(30), 2, odd, schedule="halving"))
    after = torch.tensor([float(rank)])
    dist.all_reduce(after)
    return {"out": out, "bytes": bytes_, "errors": errors,
            "after": float(after), "L": ax8.local, "index": ax8.index}


def fail(rank: int, world: int) -> None:
    """Rank 1 raises while the others wait for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 fails")
    dist.barrier()


def hang(rank: int, world: int) -> None:
    """Every rank outlives any test's time limit."""
    time.sleep(600)
