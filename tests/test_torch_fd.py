"""The port's FD collectives and DeviceEngine against the reference
package on 8 peers.

Mirrors tests/test_fd_distributed.py (FD under every schedule, CN, CN*,
batch axes, the phase-4 gather), tests/test_engine.py's DeviceEngine
tests and tests/test_serving.py's ``run_many`` stacking.  The reference
runs on 8 forced CPU devices; every JAX output comes from ONE
subprocess (written to an ``.npz``), and the port's CPU path, with its
8 virtual peers on one device, is compared with it in-process, bit for
bit (``assert_array_equal`` on the bits).  Inputs are made with numpy
from a seed: normal scores, lattice scores with many ties and signed
zeros, and a row table holding -0.0 and an infinity (the retrieval's
masked sum turns the latter into NaN where a peer reads it under a 0
mask, as the reference does).
"""
import numpy as np
import pytest
import torch

from repro.core import fd as jax_fd
from repro.core.scorelist import scorelist_bytes as jax_scorelist_bytes
from repro_torch.core import fd, mesh as M, topology
from repro_torch.core.scorelist import scorelist_bytes
from repro_torch.engine import DeviceEngine, QuerySpec
from repro_torch.kernels import _build

SCHEDULES = ("halving", "doubling", "ring")
K = 20
K2 = 6

_REFERENCE = """
import numpy as np, jax
from repro.core import fd
from repro.engine import DeviceEngine, QuerySpec
from repro.jaxcompat import make_mesh
# jitted as the reference's DeviceEngine runs them (eager shard_map is
# ~20x slower here)
fd_topk = jax.jit(fd.fd_topk, static_argnums=(1, 2, 3),
                  static_argnames=("schedule", "algorithm", "batch_axes"))
fd_topk_gather = jax.jit(fd.fd_topk_gather, static_argnums=(2, 3, 4),
                         static_argnames=("schedule", "batch_axes"))
inp = dict(np.load({inp!r}))
out = {{}}
m8 = make_mesh((8,), ("model",))
m24 = make_mesh((2, 4), ("data", "model"))
for name in ("normal", "tied"):
    s, s2 = inp[name], inp[name + "2"]
    for sch in {schedules!r}:
        v, i = fd_topk(s, {k}, m8, "model", schedule=sch)
        out[f"fd/{{name}}/{{sch}}"] = (v, i)
        v, i, r = fd_topk_gather(s, inp["rows"], {k}, m8, "model",
                                 schedule=sch)
        out[f"gather/{{name}}/{{sch}}"] = (v, i, r)
        v, i = fd_topk(s2, {k2}, m24, "model", schedule=sch,
                       batch_axes=("data",))
        out[f"fd24/{{name}}/{{sch}}"] = (v, i)
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
pols = ["fd-dynamic", "fd-basic", "cn", "fd-st1"]
fused = eng.run_many([spec] * 4, pols, scores=list(inp["many"]))
for b, res in enumerate(fused):
    out[f"many/{{b}}"] = (res.values, res.indices, res.batch_size)
res = DeviceEngine(m8, precision="bf16").run(QuerySpec(k=10), "fd-dynamic",
                                             scores=inp["normal"][0])
out["bf16"] = (res.values, res.indices)
out["bf16/precision"] = (res.precision,
                         DeviceEngine(m8).run(QuerySpec(k=10), "fd-dynamic",
                                              scores=inp["normal"][0])
                         .precision)
res = DeviceEngine(m24, batch_axes=("data",), schedule="ring").run(
    QuerySpec(k={k2}), "fd-dynamic", scores=inp["tied2"])
out["eng24"] = (res.values, res.indices)
flat = {{}}
for key, val in out.items():
    for j, a in enumerate(val):
        flat[f"{{key}}#{{j}}"] = np.asarray(a)
np.savez({out_path!r}, **flat)
print("REFERENCE_OK")
"""


def _inputs():
    rng = np.random.default_rng(12)
    normal = rng.standard_normal((2, 1024)).astype(np.float32)
    tied = (rng.integers(-4, 5, (2, 1024)) / 4.0).astype(np.float32)
    tied[(tied == 0) & (rng.random(tied.shape) < 0.5)] = -0.0
    rows = rng.standard_normal((1024, 16)).astype(np.float32)
    top = np.argsort(-normal, axis=-1, kind="stable")[:, :K]
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
    return dict(normal=normal, tied=tied, rows=rows, normal2=normal2,
                tied2=tied2, rows2=rows2, many=many)


@pytest.fixture(scope="module")
def ref(devices8, tmp_path_factory):
    """(inputs, reference outputs) — the reference's outputs all come
    from one 8-device subprocess."""
    d = tmp_path_factory.mktemp("fd_ref")
    inp = _inputs()
    np.savez(d / "inp.npz", **inp)
    out = devices8(_REFERENCE.format(
        inp=str(d / "inp.npz"), out_path=str(d / "out.npz"), k=K, k2=K2,
        schedules=SCHEDULES), timeout=600)
    assert "REFERENCE_OK" in out
    got = np.load(d / "out.npz")
    outs = {}
    for name in got.files:
        key, j = name.rsplit("#", 1)
        outs.setdefault(key, {})[int(j)] = got[name]
    return inp, {key: tuple(v[j] for j in range(len(v)))
                 for key, v in outs.items()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(port, want):
    """Exact equality, floats compared by their bits."""
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(
        port)
    assert port.dtype == want.dtype, (port.dtype, want.dtype)
    if port.dtype.kind == "f":
        port = port.view(f"i{port.itemsize}")
        want = want.view(f"i{want.itemsize}")
    np.testing.assert_array_equal(port, want)


@pytest.fixture(scope="module")
def mesh8():
    return M.make_mesh((8,), ("model",), device="cpu")


@pytest.fixture(scope="module")
def mesh24():
    return M.make_mesh((2, 4), ("data", "model"), device="cpu")


@pytest.mark.parametrize("name", ["normal", "tied"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_fd_topk_matches_reference(ref, mesh8, mesh24, name, schedule):
    """Every schedule, 8 peers and a (2, 4) mesh with a data axis: the
    reference's values and indices, including its tie order (the ring's
    differs from the global ``lax.top_k`` order on ties)."""
    inp, out = ref
    v, i = fd.fd_topk(_t(inp[name]), K, mesh8, "model", schedule=schedule)
    _eq(v, out[f"fd/{name}/{schedule}"][0])
    _eq(i, out[f"fd/{name}/{schedule}"][1])
    v, i = fd.fd_topk(_t(inp[name + "2"]), K2, mesh24, "model",
                      schedule=schedule, batch_axes=("data",))
    _eq(v, out[f"fd24/{name}/{schedule}"][0])
    _eq(i, out[f"fd24/{name}/{schedule}"][1])


@pytest.mark.parametrize("name", ["normal", "tied"])
@pytest.mark.parametrize("algorithm", ["cn", "cn_star"])
def test_cn_and_cn_star_match_reference(ref, mesh8, mesh24, name,
                                        algorithm):
    inp, out = ref
    v, i = fd.fd_topk(_t(inp[name]), K, mesh8, "model", algorithm=algorithm)
    _eq(v, out[f"{algorithm}/{name}"][0])
    _eq(i, out[f"{algorithm}/{name}"][1])
    v, i = fd.fd_topk(_t(inp[name + "2"]), K2, mesh24, "model",
                      algorithm=algorithm, batch_axes=("data",))
    _eq(v, out[f"{algorithm}24/{name}"][0])
    _eq(i, out[f"{algorithm}24/{name}"][1])


@pytest.mark.parametrize("name", ["normal", "tied"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_fd_topk_gather_matches_reference(ref, mesh8, name, schedule):
    """Phase 4 bit for bit: a -0.0 entry and an infinity read under a 0
    mask (NaN in the retrieved row) come out as in the reference, where
    a direct ``rows[idx]`` would differ."""
    inp, out = ref
    want = out[f"gather/{name}/{schedule}"]
    v, i, r = fd.fd_topk_gather(_t(inp[name]), _t(inp["rows"]), K, mesh8,
                                "model", schedule=schedule)
    _eq(v, want[0])
    _eq(i, want[1])
    _eq(r, want[2])
    direct = inp["rows"][want[1]]
    if name == "normal":
        assert np.isnan(want[2]).any() and not np.isnan(direct).any()


def test_gather_batch_axes_and_single_query(ref, mesh8, mesh24):
    inp, out = ref
    for name in ("normal", "tied"):
        got = fd.fd_topk_gather(_t(inp[name + "2"]), _t(inp["rows2"]), K2,
                                mesh24, "model", batch_axes=("data",))
        for a, b in zip(got, out[f"gather24/{name}"]):
            _eq(a, b)
    got = fd.fd_topk_gather(_t(inp["normal"][0]), _t(inp["rows"]), 4, mesh8,
                            "model")
    for a, b in zip(got, out["gather1"]):
        _eq(a, b)
    assert got[2].shape == (4, 16)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_device_engine_gather_matches_reference(ref, mesh8, schedule):
    """The engine's gather path under every schedule; the second run
    reuses the cached plan (the schedule's index tensors)."""
    inp, out = ref
    eng = DeviceEngine(mesh8, schedule=schedule)
    spec = QuerySpec(k=K)
    res = eng.run(spec, "fd-dynamic", scores=inp["normal"],
                  rows=inp["rows"])
    want = out[f"eng/{schedule}"]
    _eq(res.values, want[0])
    _eq(res.indices, want[1])
    _eq(res.rows, want[2])
    assert res.extras["model_bytes"] == int(want[3]) > 0
    assert res.backend == res.backend_used == "device-torch"
    assert res.compile_s > 0 and res.run_s > 0
    n = len(eng._compiled)
    fn = eng._compiled[("gather", K, "fd", schedule)]
    res2 = eng.run(spec, "fd-dynamic", scores=_t(inp["normal"]),
                   rows=_t(inp["rows"]))
    assert len(eng._compiled) == n and res2.compile_s == 0.0
    assert eng._compiled[("gather", K, "fd", schedule)] is fn
    _eq(res2.values, want[0])
    # every fd-* policy lowers to the same FD collective
    rb = eng.run(spec, "fd-basic", scores=inp["normal"], rows=inp["rows"])
    _eq(rb.rows, want[2])


def test_device_engine_cn_and_run_many_match_reference(ref, mesh8):
    inp, out = ref
    eng = DeviceEngine(mesh8)
    spec = QuerySpec(k=K)
    for pol in ("cn", "cn-star"):
        res = eng.run(spec, pol, scores=inp["tied"])
        _eq(res.values, out[f"eng/{pol}"][0])
        _eq(res.indices, out[f"eng/{pol}"][1])
        assert res.extras["model_bytes"] == int(out[f"eng/{pol}"][2])
    pols = ["fd-dynamic", "fd-basic", "cn", "fd-st1"]
    fused = eng.run_many([spec] * 4, pols, scores=list(inp["many"]))
    for b, res in enumerate(fused):
        want = out[f"many/{b}"]
        _eq(res.values, want[0])
        _eq(res.indices, want[1])
        assert res.batch_size == int(want[2])
        solo = eng.run(spec, pols[b], scores=inp["many"][b])
        _eq(solo.values, want[0])
        _eq(solo.indices, want[1])
    assert [r.batch_size for r in fused] == [3, 3, 1, 3]
    assert all(r.run_s > 0 for r in fused)


def test_device_engine_precision_and_batch_axes(ref, mesh8, mesh24):
    inp, out = ref
    rb = DeviceEngine(mesh8, precision="bf16").run(
        QuerySpec(k=10), "fd-dynamic", scores=inp["normal"][0])
    _eq(rb.values, out["bf16"][0])
    _eq(rb.indices, out["bf16"][1])
    assert rb.precision == str(out["bf16/precision"][0]) == "bf16"
    # bf16 engine == casting the scores by hand
    rc = DeviceEngine(mesh8).run(QuerySpec(k=10), "fd-dynamic",
                                 scores=_t(inp["normal"][0]).bfloat16())
    _eq(rc.values, out["bf16"][0])
    res = DeviceEngine(mesh8).run(QuerySpec(k=10), "fd-dynamic",
                                  scores=inp["normal"][0])
    assert res.precision == str(out["bf16/precision"][1]) == "f32"
    res = DeviceEngine(mesh24, batch_axes=("data",), schedule="ring").run(
        QuerySpec(k=K2), "fd-dynamic", scores=inp["tied2"])
    _eq(res.values, out["eng24"][0])
    _eq(res.indices, out["eng24"][1])


def test_device_engine_errors(mesh8):
    eng = DeviceEngine(mesh8)
    scores = np.zeros(1024, np.float32)
    rows = np.zeros((1024, 4), np.float32)
    with pytest.raises(ValueError, match="no device backend"):
        eng.run(QuerySpec(k=4), "fd-stats", scores=scores)
    with pytest.raises(ValueError, match="FD-only"):
        eng.run(QuerySpec(k=4), "cn", scores=scores, rows=rows)
    with pytest.raises(ValueError, match="precision"):
        DeviceEngine(mesh8, precision="f8")
    with pytest.raises(ValueError, match="one scores"):
        eng.run_many([QuerySpec(k=4)] * 2, "fd-dynamic", scores=[scores])
    with pytest.raises(RuntimeError, match="prepare"):
        DeviceEngine().run(QuerySpec(k=4), scores=scores)


def test_fd_errors_are_the_references(mesh8):
    """N not divisible by P, P not a power of two (halving, doubling),
    k > n_local, and N beyond int32 indices all raise."""
    x = torch.zeros(1004)
    with pytest.raises(ValueError, match="not divisible"):
        fd.fd_topk(x, 4, mesh8)
    with pytest.raises(ValueError, match="not divisible"):
        fd.fd_topk_gather(x, torch.zeros(1004, 2), 4, mesh8)
    m6 = M.make_mesh((6,), ("model",), device="cpu")
    x6 = torch.randn(600)
    for schedule in ("halving", "doubling"):
        with pytest.raises(ValueError, match="power of two"):
            fd.fd_topk(x6, 4, m6, schedule=schedule)
    v, _ = fd.fd_topk(x6, 4, m6, schedule="ring")    # the ring takes any P
    np.testing.assert_array_equal(v, torch.sort(x6, descending=True)[0][:4])
    with pytest.raises(ValueError, match="k=200"):
        fd.fd_topk(torch.randn(1024), 200, mesh8)
    fd.fd_topk(torch.randn(1024), 200, mesh8, algorithm="cn")  # k <= N
    with pytest.raises(ValueError, match="int32"):
        fd.fd_topk(torch.empty(2 ** 31, device="meta"), 4,
                   M.make_mesh((8,), ("model",), device="meta"))
    with pytest.raises(ValueError, match="unknown schedule"):
        fd.fd_topk(torch.randn(1024), 4, mesh8, schedule="tree")
    with pytest.raises(ValueError, match="peer axis"):
        fd.fd_topk(torch.randn(1024), 4, mesh8, batch_axes=("model",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            M.make_mesh((8,), ("model",))


@pytest.mark.parametrize("algorithm", ["fd", "cn", "cn_star"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("n_dev", [2, 8, 64])
def test_comm_bytes_equals_measured(algorithm, schedule, n_dev):
    """The closed-form model equals the walk over the rounds, and the
    reference's model."""
    args = (algorithm, n_dev, 20_000, 20)
    assert (fd.comm_bytes(*args, schedule=schedule)
            == topology.measure_comm_bytes(*args, schedule=schedule)
            == jax_fd.comm_bytes(*args, schedule=schedule))
    assert (scorelist_bytes(20, n_dev - 1)
            == jax_scorelist_bytes(20, n_dev - 1)
            == topology.schedule_list_bytes("halving", n_dev, 20))


def test_collectives_follow_jax_semantics():
    """ppermute fills non-receivers with zeros; psum starts from +0.0
    (so -0.0 terms alone give +0.0) except over one peer; all_gather
    tiles peer 0 first; every launch on the CPU path counts nothing."""
    before = dict(_build.LAUNCHES)
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 1
    perm = M.permutation([(0, 1), (2, 3)], 4, "cpu")
    np.testing.assert_array_equal(M.ppermute(x, perm),
                                  [[0, 0], [1, 2], [0, 0], [5, 6]])
    z = torch.full((3, 2), -0.0)
    assert not torch.signbit(M.psum(z)).any()
    assert torch.signbit(M.psum(z[:1])).all()
    np.testing.assert_array_equal(M.all_gather(x), x.reshape(-1))
    with pytest.raises(ValueError, match="receives twice"):
        M.permutation([(0, 1), (2, 1)], 4, "cpu")
    fd.fd_topk(torch.randn(64), 3, M.make_mesh((4,), ("model",),
                                               device="cpu"))
    assert dict(_build.LAUNCHES) == before
