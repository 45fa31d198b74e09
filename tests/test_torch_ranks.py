"""The port's FD collectives, DeviceEngine and gradient compression over
gloo ranks, against the reference package and the one-process mesh.

The reference's outputs all come from ONE JAX subprocess with 512
forced CPU devices (its production mesh needs 256; every other mesh is
made from the first 8 devices), written to an ``.npz`` as in
``tests/test_torch_fd.py``; it runs while the ranks do.  The port runs in one group of 2 and one of
4 gloo ranks on the CPU, started by ``launch.ranks.spawn_ranks`` with a
time limit (a deadlock fails the test): 8 peers as 2 x 4 and 4 x 2
ranks x peers, a (2, 4) data x model mesh under two rank layouts each,
one peer a rank for the bytes, and 4 and 8 pods for compression
(``tests/torch_ranks_worker.py`` is what each rank runs).  Every
output is held to the reference's bits, and rank r's FD list to the
one-process mesh's ``_peer_lists`` row r * L; floats are compared by
their bits.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO
from repro_torch.core import fd, mesh as M, topology
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.optim import compress as C

import torch_ranks_worker as W

sys.path.insert(0, os.path.join(REPO, "tools"))
import chip_ranks  # noqa: E402

SCHEDULES = W.SCHEDULES
WORLDS = (2, 4)
K_POD = 40
#: (k, p_drop) of the inflate_k / compression_ratio cases
INFLATE = ((1, 0.0), (137_625, 0.05), (102, 0.05), (7, 0.5))

_REFERENCE = """
import numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro.core import fd
from repro.engine import DeviceEngine, QuerySpec
from repro.jaxcompat import make_mesh, shard_map
from repro.launch.mesh import make_production_mesh
from repro.optim import compress as C
dev = jax.devices()
fd_topk = jax.jit(fd.fd_topk, static_argnums=(1, 2, 3),
                  static_argnames=("schedule", "algorithm", "batch_axes"))
fd_topk_gather = jax.jit(fd.fd_topk_gather, static_argnums=(2, 3, 4),
                         static_argnames=("schedule", "batch_axes"))
inp = {{key: jax.numpy.asarray(a) for key, a in np.load({inp!r}).items()}}
out = {{}}
m8 = make_mesh((8,), ("model",), devices=dev[:8])
m24 = make_mesh((2, 4), ("data", "model"), devices=dev[:8])
for name in ("normal", "tied"):
    s, s2 = inp[name], inp[name + "2"]
    for sch in {schedules!r}:
        out[f"fd/{{name}}/{{sch}}"] = fd_topk(s, {k}, m8, "model",
                                            schedule=sch)
        out[f"gather/{{name}}/{{sch}}"] = fd_topk_gather(
            s, inp["rows"], {k}, m8, "model", schedule=sch)
        out[f"fd24/{{name}}/{{sch}}"] = fd_topk(
            s2, {k2}, m24, "model", schedule=sch, batch_axes=("data",))
    for alg in ("cn", "cn_star"):
        out[f"{{alg}}/{{name}}"] = fd_topk(s, {k}, m8, "model", algorithm=alg)
        out[f"{{alg}}24/{{name}}"] = fd_topk(s2, {k2}, m24, "model",
                                           algorithm=alg,
                                           batch_axes=("data",))
    out[f"gather24/{{name}}"] = fd_topk_gather(
        s2, inp["rows2"], {k2}, m24, "model", batch_axes=("data",))
out["gather1"] = fd_topk_gather(inp["normal"][0], inp["rows"], 4, m8,
                                "model")
spec = QuerySpec(k={k})
for sch in {schedules!r}:
    res = DeviceEngine(m8, schedule=sch).run(
        spec, "fd-dynamic", scores=inp["normal"], rows=inp["rows"])
    out[f"eng/{{sch}}"] = (res.values, res.indices, res.rows,
                          res.extras["model_bytes"])
eng = DeviceEngine(m8)
for pol in ("cn", "cn-star"):
    res = eng.run(spec, pol, scores=inp["tied"])
    out[f"eng/{{pol}}"] = (res.values, res.indices,
                          res.extras["model_bytes"])
fused = eng.run_many([spec] * 4, ["fd-dynamic", "fd-basic", "cn", "fd-st1"],
                     scores=list(inp["many"]))
for b, res in enumerate(fused):
    out[f"many/{{b}}"] = (res.values, res.indices, res.batch_size)
res = DeviceEngine(m24, batch_axes=("data",), schedule="ring").run(
    QuerySpec(k={k2}), "fd-dynamic", scores=inp["tied2"])
out["eng24"] = (res.values, res.indices)
m4 = make_mesh((4,), ("pod",), devices=dev[:4])
def body(g, ef):
    g_hat, new_ef = C.fd_sparse_allreduce_shard(
        g[0], ef[0], k={k_pod}, axis_name="pod", axis_size=4)
    return g_hat, new_ef[None]
out["shard"] = shard_map(body, mesh=m4, in_specs=(P("pod"), P("pod")),
                         out_specs=(P(), P("pod")))(inp["pod_g"],
                                                   inp["pod_ef"])
out["pod_idx"] = (jax.vmap(lambda g, e: C.topk_sparsify(g, {k_pod}, e)[1])(
    inp["pod_g"], inp["pod_ef"]),)
out["sparsify"] = C.topk_sparsify(inp["sp_g"], 37, inp["sp_ef"])
out["dense"] = (C.sparse_to_dense(inp["sp_v"], inp["sp_i"], 64),)
m8p = make_mesh((8,), ("pod",), devices=dev[:8])
tree = {{"w": inp["tree_w"], "b": {{"v": inp["tree_b"]}}}}
state = C.compress_init(tree)
for rnd in range(2):
    g_hat, state = C.fd_sparse_allreduce(tree, state, m8p, axis="pod",
                                         k_frac=0.05, p_drop=0.05)
    out[f"tree/{{rnd}}"] = (g_hat["w"], g_hat["b"]["v"], state.ef["w"],
                           state.ef["b"]["v"])
    tree = jax.tree.map(lambda x: x * 0, tree)
for k, p_drop in {inflate!r}:
    k_eff = C.inflate_k(k, p_drop)
    out[f"inflate/{{k}}/{{p_drop}}"] = (
        k_eff, [C.compression_ratio(153_600 * 896, k_eff, pods)
                for pods in (1, 2, 4, 8)])
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi)
    out[f"production/{{multi}}"] = (np.array(list(dict(m.shape).values())),
                                   np.array(",".join(m.axis_names)))
flat = {{}}
for key, val in out.items():
    for j, a in enumerate(val):
        flat[f"{{key}}#{{j}}"] = np.asarray(a)
np.savez({out_path!r}, **flat)
print("REFERENCE_OK")
"""


def _inputs():
    rng = np.random.default_rng(26)
    normal = rng.standard_normal((2, 1024)).astype(np.float32)
    tied = (rng.integers(-4, 5, (2, 1024)) / 4.0).astype(np.float32)
    tied[(tied == 0) & (rng.random(tied.shape) < 0.5)] = -0.0
    rows = rng.standard_normal((1024, 16)).astype(np.float32)
    top = np.argsort(-normal, axis=-1, kind="stable")[:, :W.K]
    rows[top[0, 0], 3] = -0.0          # a -0.0 entry in a winning row
    rows[top[1, 1], :] = -0.0          # a winning row of -0.0 only
    rows[7 * 128, 2] = np.inf          # peer 7's local row 0: read under a
    #                                    0 mask by every winner owned below
    normal2 = rng.standard_normal((4, 512)).astype(np.float32)
    tied2 = (rng.integers(-3, 4, (4, 512)) / 2.0).astype(np.float32)
    tied2[(tied2 == 0) & (rng.random(tied2.shape) < 0.5)] = -0.0
    rows2 = rng.standard_normal((512, 8)).astype(np.float32)
    rows2[np.argmax(normal2[0]), 1] = -0.0
    many = rng.standard_normal((4, 1024)).astype(np.float32)
    # 4 pods' gradients: a shared part and each pod's own noise, so that
    # most winners are chosen by three or four pods; the error feedback
    # of an earlier round, with signed zeros
    shared = rng.standard_normal((64, 32)).astype(np.float32)
    pod_g = (shared + 0.3 * rng.standard_normal((4, 64, 32))).astype(
        np.float32)
    pod_ef = (0.1 * rng.standard_normal((4, 64, 32))).astype(np.float32)
    pod_ef[rng.random(pod_ef.shape) < 0.2] = -0.0
    # magnitudes that tie (x and -x): the top-k's lowest-index order
    sp_g = (rng.integers(-6, 7, (16, 12)) / 2.0).astype(np.float32)
    sp_ef = np.zeros((16, 12), np.float32)
    sp_ef[::3] = -0.0
    sp_i = rng.integers(0, 64, 40).astype(np.int32)     # repeated indices
    sp_v = rng.standard_normal(40).astype(np.float32)
    tree_w = (rng.laplace(size=(64, 32)) ** 3).astype(np.float32)
    tree_b = rng.standard_normal(48).astype(np.float32)
    return dict(normal=normal, tied=tied, rows=rows, normal2=normal2,
                tied2=tied2, rows2=rows2, many=many, pod_g=pod_g,
                pod_ef=pod_ef, pod_k=np.int64(K_POD), sp_g=sp_g,
                sp_ef=sp_ef, sp_i=sp_i, sp_v=sp_v, tree_w=tree_w,
                tree_b=tree_b)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def pending_ref(inputs, tmp_path_factory):
    """The reference's subprocess, started (it runs while the ranks
    do): (process, output path)."""
    d = tmp_path_factory.mktemp("ranks_ref")
    np.savez(d / "inp.npz", **inputs)
    code = _REFERENCE.format(
        inp=str(d / "inp.npz"), out_path=str(d / "out.npz"), k=W.K,
        k2=W.K2, k_pod=K_POD, schedules=SCHEDULES, inflate=INFLATE)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, d / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(inputs, pending_ref):
    """Each world size's rank results, rank 0 first: one group of gloo
    ranks per world size, each with its own time limit."""
    return {world: spawn_ranks(W.run, world, args=(inputs,), timeout=240)
            for world in WORLDS}


@pytest.fixture(scope="module")
def ref(inputs, pending_ref, ranks):
    """(inputs, reference outputs) — one 512-device JAX subprocess."""
    proc, path = pending_ref
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "REFERENCE_OK" in out, out + err
    got = np.load(path)
    outs = {}
    for name in got.files:
        key, j = name.rsplit("#", 1)
        outs.setdefault(key, {})[int(j)] = got[name]
    return inputs, {key: tuple(v[j] for j in range(len(v)))
                    for key, v in outs.items()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(port, want):
    """Exact equality, floats compared by their bits."""
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(
        port)
    want = np.asarray(want)
    assert port.dtype == want.dtype, (port.dtype, want.dtype)
    if port.dtype.kind == "f":
        port = port.view(f"i{port.itemsize}")
        want = want.view(f"i{want.itemsize}")
    np.testing.assert_array_equal(port, want)


def _one_process_rows(scores, k, schedule, peers=8):
    """The one-process mesh's every peer's list, (..., P, k)."""
    x = _t(scores)
    return fd._peer_lists(x.reshape(x.shape[:-1] + (peers, -1)), k,
                          schedule, None)


def _held_to_lists(got, want, lists, L, schedule):
    """Every rank's FD list: the reference's values; rank 0's indices
    the reference's (every rank's under halving); rank r's indices the
    one-process row r * L."""
    for r, (v, i) in enumerate(got):
        _eq(v, want[0])
        if r == 0 or schedule == "halving":
            _eq(i, want[1])
        _eq(i, lists[1][..., r * L, :])
        _eq(v, lists[0][..., r * L, :])


@pytest.mark.parametrize("name", ["normal", "tied"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("world", WORLDS)
def test_fd_over_ranks_matches_reference(ref, ranks, world, schedule, name):
    """8 peers as 2 x 4 and 4 x 2 ranks x peers, every schedule."""
    inp, out = ref
    res = ranks[world]
    L = res[0]["L"]
    assert L == 8 // world and [r["index"] for r in res] == list(
        range(world))
    lists = _one_process_rows(inp[name], W.K, schedule)
    _held_to_lists([r["out"][f"fd/{name}/{schedule}"] for r in res],
                   out[f"fd/{name}/{schedule}"], lists, L, schedule)


@pytest.mark.parametrize("name", ["normal", "tied"])
@pytest.mark.parametrize("algorithm", ["cn", "cn_star"])
@pytest.mark.parametrize("world", WORLDS)
def test_cn_and_cn_star_over_ranks_match_reference(ref, ranks, world,
                                                   algorithm, name):
    """CN gathers every score, CN* every k-list: each rank computes the
    replicated answer itself."""
    _, out = ref
    for r in ranks[world]:
        got = r["out"][f"{algorithm}/{name}"]
        _eq(got[0], out[f"{algorithm}/{name}"][0])
        _eq(got[1], out[f"{algorithm}/{name}"][1])


@pytest.mark.parametrize("name", ["normal", "tied"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("world", WORLDS)
def test_gather_over_ranks_matches_reference(ref, ranks, world, schedule,
                                             name):
    """Phase 4 across ranks: the retrieval is a real sum over every
    peer (an infinity under a 0 mask gives NaN, -0.0 rows stay as the
    reference's), the same rows on every rank."""
    inp, out = ref
    want = out[f"gather/{name}/{schedule}"]
    lists = _one_process_rows(inp[name], W.K, schedule)
    res = ranks[world]
    _held_to_lists([r["out"][f"gather/{name}/{schedule}"][:2] for r in res],
                   want, lists, res[0]["L"], schedule)
    for r in res:
        _eq(r["out"][f"gather/{name}/{schedule}"][2], want[2])
        for a, b in zip(r["out"]["gather1"], out["gather1"]):
            _eq(a, b)
    if name == "normal":
        assert np.isnan(want[2]).any()


@pytest.mark.parametrize("world", WORLDS)
def test_batch_axes_over_ranks_match_reference(ref, ranks, world):
    """A (2, 4) data x model mesh under two rank layouts: with the data
    axis over ranks each data rank takes its half of the batch and the
    result is gathered back; the model group runs the rounds."""
    inp, out = ref
    for lay in W.LAYOUTS[world]:
        L = 4 // lay[1]
        for name in ("normal", "tied"):
            for sch in SCHEDULES:
                lists = _one_process_rows(inp[name + "2"], W.K2, sch, 4)
                got = [r["out"][f"fd24/{lay}/{name}/{sch}"]
                       for r in ranks[world]]
                # rank (d, m) answers with model peer m * L
                for r, (v, i) in enumerate(got):
                    m = r % lay[1]
                    _eq(v, out[f"fd24/{name}/{sch}"][0])
                    _eq(i, lists[1][:, m * L, :])
                    if m == 0 or sch == "halving":
                        _eq(i, out[f"fd24/{name}/{sch}"][1])
            for r in ranks[world]:
                for alg in ("cn", "cn_star"):
                    for a, b in zip(r["out"][f"{alg}24/{lay}/{name}"],
                                    out[f"{alg}24/{name}"]):
                        _eq(a, b)
                for a, b in zip(r["out"][f"gather24/{lay}/{name}"],
                                out[f"gather24/{name}"]):
                    _eq(a, b)
        lists = _one_process_rows(inp["tied2"], W.K2, "ring", 4)
        for r, res in enumerate(ranks[world]):
            _eq(res["out"][f"eng24/{lay}"][0], out["eng24"][0])
            _eq(res["out"][f"eng24/{lay}"][1],
                lists[1][:, (r % lay[1]) * L, :])


@pytest.mark.parametrize("world", WORLDS)
def test_device_engine_over_ranks_matches_reference(ref, ranks, world):
    """The engine's gather path under every schedule (its cached rounds
    reused by a second call), CN and CN*, and ``run_many``'s stacking,
    each rank on its block."""
    inp, out = ref
    res = ranks[world]
    L = res[0]["L"]
    for sch in SCHEDULES:
        want = out[f"eng/{sch}"]
        lists = _one_process_rows(inp["normal"], W.K, sch)
        for r, got in enumerate(res):
            v, i, rows, model_bytes, backend, compile_s, again = got["out"][
                f"eng/{sch}"]
            _eq(v, want[0])
            _eq(again, want[0])
            _eq(i, lists[1][:, r * L, :])
            _eq(rows, want[2])
            assert model_bytes == int(want[3])
            assert backend == "device-torch" and compile_s == 0.0
    for got in res:
        for pol in ("cn", "cn-star"):
            _eq(got["out"][f"eng/{pol}"][0], out[f"eng/{pol}"][0])
            _eq(got["out"][f"eng/{pol}"][1], out[f"eng/{pol}"][1])
            assert got["out"][f"eng/{pol}"][2] == int(out[f"eng/{pol}"][2])
        for b in range(4):
            v, i, batch = got["out"][f"many/{b}"]
            _eq(v, out[f"many/{b}"][0])
            assert batch == int(out[f"many/{b}"][2])
    for b in range(4):
        _eq(res[0]["out"][f"many/{b}"][1], out[f"many/{b}"][1])


@pytest.mark.parametrize("case", ["fd/halving", "fd/doubling", "fd/ring",
                                  "cn/-", "cn_star/-"])
@pytest.mark.parametrize("world", WORLDS)
def test_bytes_between_ranks_equal_comm_bytes(ranks, world, case):
    """At one peer a rank, the payload the ranks deliver to each other
    is the paper's traffic: ``comm_bytes`` and the walk over the
    rounds."""
    alg, sch = case.split("/")
    sch = "halving" if sch == "-" else sch
    res = ranks[world]
    sent = sum(r["bytes"][case] for r in res)
    args = (alg, world, res[0]["bytes"]["n_local"], 5)
    assert sent == fd.comm_bytes(*args, schedule=sch) == \
        topology.measure_comm_bytes(*args, schedule=sch) > 0


@pytest.mark.parametrize("world", WORLDS)
def test_compress_shard_over_ranks_matches_reference(ref, ranks, world):
    """4 pods of their own gradients (one or two a rank): every rank's
    mean is the reference's, bit for bit, with indices that three or
    more pods chose; rank r's error feedback is its pods'."""
    inp, out = ref
    counts = np.bincount(out["pod_idx"][0].ravel(), minlength=64 * 32)
    assert (counts >= 3).sum() > 10
    L = 4 // world
    for r, got in enumerate(ranks[world]):
        g_hat, new_ef = got["out"]["shard"]
        _eq(g_hat, out["shard"][0])
        _eq(new_ef, out["shard"][1][r * L:(r + 1) * L])


@pytest.mark.parametrize("world", WORLDS)
def test_compress_tree_over_ranks_matches_reference(ref, ranks, world):
    """The tree-wise mean over 8 pods of replicated gradients, two
    rounds (the second drains the error feedback)."""
    _, out = ref
    for got in ranks[world]:
        for rnd in range(2):
            for a, b in zip(got["out"][f"tree/{rnd}"], out[f"tree/{rnd}"]):
                _eq(a, b)


def test_compress_on_one_process_matches_reference(ref):
    """The same functions with every pod on one process: topk_sparsify
    on tied magnitudes, sparse_to_dense on repeated indices, the shard
    function on 4 stacked pods and the tree-wise mean over 8."""
    inp, out = ref
    got = C.topk_sparsify(_t(inp["sp_g"]), 37, _t(inp["sp_ef"]))
    for a, b in zip(got, out["sparsify"]):
        _eq(a, b)
    _eq(C.sparse_to_dense(_t(inp["sp_v"]), _t(inp["sp_i"]), 64),
        out["dense"][0])
    pods = M.make_mesh((4,), ("pod",), device="cpu")
    g_hat, new_ef = C.fd_sparse_allreduce_shard(
        _t(inp["pod_g"]), _t(inp["pod_ef"]), k=K_POD, axis=pods.axis("pod"))
    _eq(g_hat, out["shard"][0])
    _eq(new_ef, out["shard"][1])
    tree = {"w": _t(inp["tree_w"]), "b": {"v": _t(inp["tree_b"])}}
    state = C.compress_init(tree)
    mesh = M.make_mesh((8,), ("pod",), device="cpu")
    for rnd in range(2):
        g_hat, state = C.fd_sparse_allreduce(tree, state, mesh, axis="pod",
                                             k_frac=0.05, p_drop=0.05)
        for a, b in zip((g_hat["w"], g_hat["b"]["v"], state.ef["w"],
                         state.ef["b"]["v"]), out[f"tree/{rnd}"]):
            _eq(a, b)
        tree = {"w": torch.zeros(64, 32), "b": {"v": torch.zeros(48)}}


@pytest.mark.parametrize("k,p_drop", INFLATE)
def test_inflate_k_and_compression_ratio_match_reference(ref, k, p_drop):
    _, out = ref
    k_eff, ratios = out[f"inflate/{k}/{p_drop}"]
    assert C.inflate_k(k, p_drop) == int(k_eff)
    assert [C.compression_ratio(153_600 * 896, int(k_eff), pods)
            for pods in (1, 2, 4, 8)] == ratios.tolist()
    with pytest.raises(ValueError, match="p_drop"):
        C.inflate_k(k, 1.0)


@pytest.mark.parametrize("world", WORLDS)
def test_production_mesh_matches_reference(ref, ranks, world):
    """The reference's shape and axis names, virtual on one process or
    split over the ranks along the outermost axis."""
    _, out = ref
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi, device="cpu")
        want = out[f"production/{multi}"]
        assert list(m.shape.values()) == want[0].tolist()
        assert ",".join(m.axis_names) == str(want[1])
        assert not m.multi_rank
    for r in ranks[world]:
        shape, names, layout = r["out"]["production"]
        assert list(shape.values()) == out["production/False"][0].tolist()
        assert ",".join(names) == str(out["production/False"][1])
        assert layout == {"data": world, "model": 1}


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_on_every_rank_before_any_collective(ranks, world):
    """A block that does not fit the mesh, rows that do not match it,
    a k beyond a peer's shard, ranks that do not divide an axis (or the
    production mesh's), a layout that is not the group's and a halving
    over 3 peers a rank: every rank raises, and the group goes on."""
    res = ranks[world]
    for r in res:
        e = r["errors"]
        assert e["block"].startswith("ValueError") and "not divisible" in \
            e["block"]
        assert "rows must be" in e["rows"]
        assert "k=200" in e["k"]
        assert "do not divide mesh axis" in e["ranks"]
        assert "span 1 ranks" in e["layout"]
        assert "power of two" in e["halving"]
        if world == 4:
            assert e["production"].startswith("RuntimeError") and \
                "do not divide" in e["production"]
        else:
            assert e["production"] == "no error"
        assert r["after"] == sum(range(world))


def test_spawn_ranks_fails_on_a_dead_or_hung_rank():
    """A rank that raises fails the group (the others are killed), and
    ranks that outlive the time limit are killed and raise."""
    with pytest.raises(Exception, match="rank 1 fails"):
        spawn_ranks(W.fail, 2, timeout=120)
    with pytest.raises(TimeoutError):
        spawn_ranks(W.hang, 2, timeout=5)


def test_chip_smoke_rank_phase_on_the_cpu():
    """chip_smoke.py phase 15's rank code (``tools/chip_ranks.py``) on
    4 gloo ranks of the CPU path at a small size: every check it makes
    on the card passes (each rank == the one-process rows, compression
    == the computation with topk_ref, the error feedback drained), the
    ranks' g_hat digests agree and the k-list bytes are the model's."""
    leaves = [("embed", (96, 16)), ("layers.0.mixer.wq", (16, 16)),
              ("layers.0.norm", (16,)), ("norm_f.scale", (16,))]
    conf = dict(peers=8, local=64, k=5, k_large=30, batch=4, d=3, seed=15,
                leaves=leaves, noise=0.3, k_frac=1e-2, p_drop=0.05,
                device="cpu")
    outs = spawn_ranks(chip_ranks.run, 4, args=(conf,), timeout=120)
    assert all(o["compress"]["digests"] == outs[0]["compress"]["digests"]
               for o in outs)
    c = outs[0]["compress"]
    assert c["three_or_more"] > 0 and c["ef_l1"][1] < c["ef_l1"][0]
    for o in outs:
        assert o["compress"]["sent_bytes"] == [c["list_bytes"]] * 2
        assert o["device"]["L"] == 2
