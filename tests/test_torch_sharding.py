"""The port's partition rules (``repro_torch.optim.sharding``) against
the reference's, and its placement of blocks against ``NamedSharding``.

The reference's outputs come from ONE JAX subprocess with 4 forced CPU
devices, written as JSON: for every registered arch at full size
(shapes from ``jax.eval_shape``, nothing allocated) the specs of
``param_specs``, ``opt_state_specs``, ``decode_state_specs`` and
``input_specs_pytree`` on four meshes, and for the smoke configs each
device's index slices from ``NamedSharding(mesh, spec)
.devices_indices_map(shape)`` on four real 4-device meshes.  The port
side maps each reference leaf to its parameter name (layer ``g * P +
slot`` is group g of slot ``slot``, the rest ``rem``, as
``params_from_reference`` stacks them; ``torch_lm_ref.ref_leaf``), drops
the reference's scan dim, and compares.  The blocks of a rank are
checked on a stand-in mesh that reports one rank's coordinates: no
process group is needed to cut a leaf.
"""
import json
import math

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.ckpt.elastic import largest_pow2_leq, make_elastic_mesh
from repro_torch.configs.base import get_config, list_archs, smoke_config
from repro_torch.core.mesh import Axis
from repro_torch.models import model as M
from repro_torch.optim import sharding as S

from torch_lm_ref import ref_leaf

B, S_MAX, MAX_SEQ = 32, 4096, 4096
#: the fake meshes of the spec tables
MESHES = {"sp": {"data": 16, "model": 16},
          "mp": {"pod": 2, "data": 16, "model": 16},
          "d2m2": {"data": 2, "model": 2},
          "d4m1": {"data": 4, "model": 1}}
#: the real 4-device meshes of the layout checks
LAYOUTS = {"d2m2": ((2, 2), ("data", "model")),
           "d4m1": ((4, 1), ("data", "model")),
           "d1m4": ((1, 4), ("data", "model")),
           "p2d2": ((2, 2, 1), ("pod", "data", "model"))}
LAYOUT_ARCHS = ("granite-moe-1b-a400m", "qwen2-0.5b", "minicpm3-4b",
                "recurrentgemma-2b", "whisper-large-v3", "rwkv6-3b")

_REFERENCE = """
import json, numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_config, list_archs, smoke_config
from repro.jaxcompat import make_mesh
from repro.models import model as M
from repro.optim import sharding as S

class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)

def key_of(path):
    out = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
    return "/".join(out)

def entry(e):
    return list(e) if isinstance(e, tuple) else e

def leaves(tree, specs):
    got = {{}}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        got[key_of(path)] = [list(leaf.shape)]
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        got[key_of(path)].append([entry(e) for e in s])
    return got

out = {{"full": {{}}, "smoke": {{}}, "layout": {{}}}}
for arch in list_archs():
    cfg = get_config(arch)
    ps = jax.eval_shape(lambda k: M.init_params(k, cfg, max_seq={max_seq}),
                        jax.random.PRNGKey(0))
    st = jax.eval_shape(lambda: M.init_decode_state(cfg, batch={b},
                                                    s_max={s_max}))
    batch = {{"tokens": jax.ShapeDtypeStruct(({b}, {s_max}), np.int32),
             "one": jax.ShapeDtypeStruct((1, {s_max}), np.int32),
             "frames": jax.ShapeDtypeStruct(({b}, 1500, 8), np.float32)}}
    a = out["full"][arch] = {{}}
    for name, shape in {meshes!r}.items():
        fm = FakeMesh(shape)
        a[name] = {{
            "params": leaves(ps, S.param_specs(ps, cfg, fm)),
            "opt": leaves(ps, S.opt_state_specs(ps, cfg, fm)),
            "decode": leaves(st, S.decode_state_specs(st, cfg, fm,
                                                      s_max={s_max})),
            "input": leaves(batch, S.input_specs_pytree(batch, fm))}}
    sm = smoke_config(cfg)
    ps = jax.eval_shape(lambda k: M.init_params(k, sm, max_seq=64),
                        jax.random.PRNGKey(0))
    out["smoke"][arch] = {{k: v[0] for k, v in leaves(
        ps, S.param_specs(ps, sm, FakeMesh({{"data": 1}}))).items()}}
    if arch not in {layout_archs!r}:
        continue
    lay = out["layout"][arch] = {{}}
    for name, (shape, axes) in {layouts!r}.items():
        mesh = make_mesh(shape, axes,
                         devices=jax.devices()[:int(np.prod(shape))])
        specs = S.param_specs(ps, sm, mesh)
        rows = {{}}
        for (path, leaf), (_, spec) in zip(
                jax.tree_util.tree_flatten_with_path(ps)[0],
                jax.tree_util.tree_flatten_with_path(
                    specs, is_leaf=lambda x: isinstance(x, P))[0]):
            idx = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
            cells = []
            for coord in np.ndindex(*shape):
                sl = idx[mesh.devices[coord]]
                cells.append([[s.indices(n)[0], s.indices(n)[1]]
                              for s, n in zip(sl, leaf.shape)])
            rows[key_of(path)] = [[entry(e) for e in spec], cells]
        lay[name] = rows
with open({out_path!r}, "w") as f:
    json.dump(out, f)
print("REFERENCE_OK")
"""


def _entry(e):
    """A spec entry as JSON holds it (a tuple as a list)."""
    return list(e) if isinstance(e, tuple) else e


def _json_spec(spec):
    return [_entry(e) for e in spec]


def _pad(spec, ndim):
    return list(spec) + [None] * (ndim - len(spec))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharding_ref") / "out.json"
    out = run_with_devices(_REFERENCE.format(
        max_seq=MAX_SEQ, b=B, s_max=S_MAX, meshes=MESHES,
        layout_archs=LAYOUT_ARCHS, layouts=LAYOUTS, out_path=str(path)),
        n_devices=4, timeout=600)
    assert "REFERENCE_OK" in out
    with open(path) as f:
        return json.load(f)


def port_leaves(ref_leaves, cfg):
    """``{port name: (reference key, group index or None, port shape)}``
    of the reference's parameter leaves ``{key: shape, ...}``."""
    p = len(cfg.mixer_pattern)
    grouped = cfg.n_layers // p * p
    out = {}
    for key, shape in ref_leaves.items():
        parts = key.split("/")
        rest = ".".join(parts[3:])
        if parts[:2] == ["dec", "groups"]:
            for g in range(shape[0]):
                out[f"layers.{g * p + int(parts[2])}.{rest}"] = (
                    key, g, tuple(shape[1:]))
        elif parts[:2] == ["dec", "rem"]:
            out[f"layers.{grouped + int(parts[2])}.{rest}"] = (
                key, None, tuple(shape))
        elif parts[:3] == ["enc", "stack", "groups"]:
            for g in range(shape[0]):
                out[f"enc.layers.{g}.{'.'.join(parts[4:])}"] = (
                    key, g, tuple(shape[1:]))
        else:
            out[".".join(parts)] = (key, None, tuple(shape))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_name_map_is_the_ports(ref, arch):
    """The name map gives the port's own parameters, shapes and all
    (smoke configs, allocated), and agrees with ``ref_leaf``."""
    cfg = smoke_config(get_config(arch))
    names = port_leaves(ref["smoke"][arch], cfg)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           max_seq=64, device="cpu")
    assert {n: tuple(p.shape) for n, p in params.named_parameters()} == {
        n: v[2] for n, v in names.items()}
    for name, (key, g, _) in names.items():
        assert ref_leaf(name, cfg) == (key, g), name


def _ref_spec(entry, ndim):
    """The reference's spec of a leaf, its scan dim dropped."""
    (key, g, _), spec = entry
    return _pad(spec[1:] if g is not None else spec, ndim)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_opt_specs_match_reference(ref, arch, mesh):
    """``param_specs`` and ``opt_state_specs`` on every parameter of the
    full-size arch, from ``{name: shape}`` alone."""
    cfg = get_config(arch)
    want = ref["full"][arch][mesh]
    names = port_leaves({k: v[0] for k, v in want["params"].items()}, cfg)
    shapes = {n: v[2] for n, v in names.items()}
    for what, fn in (("params", S.param_specs), ("opt", S.opt_state_specs)):
        got = fn(shapes, cfg, MESHES[mesh])
        assert set(got) == set(names)
        for name, (key, g, shape) in names.items():
            ref_spec = want[what][key][1]
            expect = _pad(ref_spec[1:] if g is not None else ref_spec,
                          len(shape))
            assert _json_spec(got[name]) == expect, (what, name)


def _flat_state(tree, prefix=""):
    """A port decode state's (or spec structure's) leaves by key."""
    out = {}
    if isinstance(tree, (torch.Tensor,)) or (
            isinstance(tree, tuple) and not hasattr(tree, "_fields")):
        return {prefix: tree}
    if hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(_flat_state(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_decode_state_and_input_specs_match_reference(ref, arch, mesh):
    """``decode_state_specs`` on the full-size decode state (meta
    tensors: shapes only), each layer held to its scan group's or
    remainder's leaf, and ``input_specs_pytree``."""
    cfg = get_config(arch)
    want = ref["full"][arch][mesh]
    state = M.init_decode_state(cfg, batch=B, s_max=S_MAX, device="meta")
    specs = _flat_state(S.decode_state_specs(state, cfg, MESHES[mesh],
                                             s_max=S_MAX))
    shapes = _flat_state(state)
    p = len(cfg.mixer_pattern)
    grouped = cfg.n_layers // p * p
    seen = set()
    for key, spec in specs.items():
        if key == "pos":
            assert spec == () and want["decode"]["pos"][1] == []
            continue
        _, i, rest = key.split("/", 2)
        i = int(i)
        stacked = i < grouped
        ref_key = (f"caches/groups/{i % p}/{rest}" if stacked
                   else f"caches/rem/{i - grouped}/{rest}")
        ref_shape, ref_spec = want["decode"][ref_key]
        shape = tuple(shapes[key].shape)
        assert tuple(ref_shape[1:] if stacked else ref_shape) == shape
        expect = _pad(ref_spec[1:] if stacked else ref_spec, len(shape))
        assert _json_spec(spec) == expect, key
        seen.add(ref_key)
    assert seen == set(want["decode"]) - {"pos"}
    batch = {"tokens": (B, S_MAX), "one": (1, S_MAX), "frames": (B, 1500, 8)}
    got = S.input_specs_pytree(batch, MESHES[mesh])
    for k, (_, spec) in want["input"].items():
        assert _json_spec(got[k]) == _pad(spec, len(batch[k])), k


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_divisibility(ref, arch, mesh):
    """INVARIANT (the reference's ``test_param_specs_divisibility``):
    every sharded dim divides the product of its axes, and on the
    production meshes at least half the leaves are sharded (ZeRO / TP
    coverage).  The port's leaves are per layer, the reference's per
    scan group: the share is over the port's leaves."""
    cfg = get_config(arch)
    shape = MESHES[mesh]
    names = port_leaves({k: v[0] for k, v in
                         ref["full"][arch][mesh]["params"].items()}, cfg)
    params = {n: v[2] for n, v in names.items()}
    specs = S.param_specs(params, cfg, shape)
    n_sharded = 0
    for name, spec in specs.items():
        assert len(spec) == len(params[name])
        for d, ax in enumerate(spec):
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else ax
            size = math.prod(shape[a] for a in axes)
            assert params[name][d] % size == 0, (arch, name, spec)
            n_sharded += 1
    if mesh in ("sp", "mp"):
        assert n_sharded >= 0.5 * len(params), (arch, n_sharded)


class RankView:
    """A stand-in for a mesh over ranks as one rank sees it: each axis
    spans ``ranks[a]`` ranks and this rank sits at ``coord[a]``.
    ``shard_leaf`` reads nothing else of a mesh."""

    def __init__(self, shape, ranks, coord):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self._axes = {a: Axis(a, shape[a], ranks[a], coord[a], None, None,
                              self) for a in shape}

    def axis(self, name):
        return self._axes[name]


def _cases(layout):
    """(rank layout, the axis whose peers a rank holds two of, or None)
    of a mesh shape: one peer a rank, and each axis of more than one
    peer over half as many ranks where no spec joins it with another
    axis in one entry (``("pod", "data")`` is checked in
    :func:`test_virtual_axes_leave_the_dim_whole`)."""
    shape, axes = LAYOUTS[layout]
    out = [(shape, None)]
    for a, n in enumerate(shape):
        if n > 1 and "pod" not in axes:
            out.append((shape[:a] + (n // 2,) + shape[a + 1:], a))
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_blocks_are_named_sharding_slices(ref, arch, layout):
    """``shard_leaf``'s block for each rank coordinate is the index slice
    ``NamedSharding(mesh, spec).devices_indices_map`` gives that device
    (one peer a rank), or the join of the slices of the rank's peers
    (two peers a rank on one axis), for every parameter of the smoke
    config, and ``global_shape`` gives the whole leaf's shape back."""
    cfg = smoke_config(get_config(arch))
    shape, axes = LAYOUTS[layout]
    mesh_shape = dict(zip(axes, shape))
    rows = ref["layout"][arch][layout]
    names = port_leaves({k: [len(v[1][0])] and _whole(v) for k, v in
                         rows.items()}, cfg)
    specs = S.param_specs({n: v[2] for n, v in names.items()}, cfg,
                          mesh_shape)
    for ranks, split in _cases(layout):
        for coord in np.ndindex(*ranks):
            view = RankView(mesh_shape, dict(zip(axes, ranks)),
                            dict(zip(axes, coord)))
            for name, (key, g, pshape) in names.items():
                ref_spec, cells = rows[key]
                assert _json_spec(specs[name]) == _pad(
                    ref_spec[1:] if g is not None else ref_spec,
                    len(pshape)), name
                x = torch.arange(math.prod(pshape)).reshape(pshape)
                got = S.shard_leaf(x, specs[name], view)
                assert S.global_shape(got.shape, specs[name],
                                      view) == pshape
                peers = [coord] if split is None else [
                    coord[:split] + (2 * coord[split] + j,)
                    + coord[split + 1:] for j in (0, 1)]
                boxes = []
                for c in peers:
                    sl = cells[int(np.ravel_multi_index(c, shape))]
                    boxes.append(sl[1:] if g is not None else sl)
                assert torch.equal(got, x[_union(boxes)]), (name, ranks,
                                                           coord)


def _whole(row):
    """A leaf's shape from its first device's slices' ends (the shapes
    are not in the layout rows; the first device's slice ends at the
    full extent on every dim the spec leaves whole)."""
    spec, cells = row
    ends = np.max(np.array(cells)[:, :, 1], axis=0)
    return [int(e) for e in ends]


def _union(boxes):
    """The index box the peers' slices tile together (equal boxes where
    the spec leaves their axis whole, abutting ones where it cuts)."""
    lo = [min(b[d][0] for b in boxes) for d in range(len(boxes[0]))]
    hi = [max(b[d][1] for b in boxes) for d in range(len(boxes[0]))]
    distinct = {tuple(map(tuple, b)) for b in boxes}
    assert math.prod(h - l for l, h in zip(lo, hi)) == sum(
        math.prod(e - s for s, e in b) for b in distinct)
    return tuple(slice(l, h) for l, h in zip(lo, hi))


def test_virtual_axes_leave_the_dim_whole():
    """Only the axes that span ranks cut a dim: with ``pod`` held as two
    virtual peers on each of 2 data ranks, ``("pod", "data")`` cuts the
    dim in two by the data rank (the join of the rank's peers' blocks
    under ``NamedSharding`` would not be one block); ``model`` virtual
    leaves its dim whole; the blocks of 2 x 2 ranks join row-major;
    ``gather_leaf`` over no rank axis is the block itself."""
    shape = {"pod": 2, "data": 2, "model": 2}
    x = torch.arange(8 * 6).reshape(8, 6)
    for j in range(2):
        view = RankView(shape, {"pod": 1, "data": 2, "model": 1},
                        {"pod": 0, "data": j, "model": 0})
        got = S.shard_leaf(x, (("pod", "data"), "model"), view)
        assert torch.equal(got, x[4 * j:4 * j + 4])
        assert S.global_shape(got.shape, (("pod", "data"), "model"),
                              view) == (8, 6)
    for p in range(2):
        for j in range(2):
            view = RankView(shape, {"pod": 2, "data": 2, "model": 1},
                            {"pod": p, "data": j, "model": 0})
            got = S.shard_leaf(x, (("pod", "data"), None), view)
            assert torch.equal(got, x[2 * (2 * p + j):2 * (2 * p + j) + 2])
    one = RankView(shape, {"pod": 1, "data": 1, "model": 1},
                   {"pod": 0, "data": 0, "model": 0})
    assert S.shard_leaf(x, ("data", "model"), one) is x
    assert S.gather_leaf(x, ("data", "model"), one) is x


def test_elastic_mesh_sizes():
    """``make_elastic_mesh``: the largest power-of-two data axis that
    fits the ranks (3 ranks of model 1: data 2; 7 of model 2: data 2),
    virtual peers on one process; too few ranks for the model axis
    raise."""
    assert [largest_pow2_leq(n) for n in (1, 2, 3, 4, 7, 8, 9)] == [
        1, 2, 2, 4, 4, 8, 8]
    m = make_elastic_mesh(3, 1, device="cpu")
    assert m.shape == {"data": 2, "model": 1} and not m.multi_rank
    assert make_elastic_mesh(7, 2, device="cpu").shape == {"data": 2,
                                                           "model": 2}
    with pytest.raises(ValueError, match="cannot host"):
        make_elastic_mesh(1, 2, device="cpu")


def test_mesh_helpers_read_the_current_mesh():
    """``layers.use_mesh``'s helpers answer as the reference's read the
    ambient mesh: the batch axes present, the model axis's size, a head
    axis only where the heads divide it; and the data shards this
    process holds (every virtual data peer); nothing outside a mesh."""
    from repro_torch.core.mesh import Mesh
    from repro_torch.models import layers as L
    assert (L.batch_spec(), L.model_size(), L.head_axis(8),
            L._mesh_axis_names(), L.local_batch_shards()) == (
        None, 1, None, (), 1)
    with L.use_mesh(Mesh((2, 4), ("data", "model"), "cpu")):
        assert L.batch_spec() == ("data",) and L.model_size() == 4
        assert L.head_axis(8) == "model" and L.head_axis(6) is None
        assert L._mesh_axis_names() == ("data", "model")
        assert L.local_batch_shards() == 2
        with L.use_mesh(Mesh((2, 3, 1), ("pod", "data", "model"), "cpu")):
            assert L.batch_spec() == ("pod", "data")
            assert L.local_batch_shards() == 6 and L.head_axis(8) is None
        assert L.local_batch_shards() == 2
    assert L.batch_spec() is None
