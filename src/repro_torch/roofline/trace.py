"""What one call of a step does, counted from the ops PyTorch dispatches.

The port's counterpart of ``src/repro/roofline/hlo_parse.py``.  The
reference parses the compiled per-device HLO of a step; the port runs
eagerly and has no HLO, so :func:`analyze` runs the step itself under a
``TorchDispatchMode`` (which sees every aten op, every ``c10d``
collective and every call of the port's kernel ops) together with
``torch.utils.flop_counter.FlopCounterMode``.  The step may run on real
tensors or on fake ones (``FakeTensorMode``: shapes, dtypes and a
device, no storage), which is how ``launch/dryrun.py`` traces a
full-size rank of a 256- or 512-rank world without a card.

The :class:`Totals` keep the reference's field names:

* ``flops``: ``FlopCounterMode``'s count, i.e. the matmuls, batched
  matmuls, convolutions and attention products, as the reference's
  ``_dot_flops`` / ``_conv_flops`` count dots and convolutions;
* ``bytes_accessed``: each op's input and output bytes on the traced
  device (``device``, ``"cuda"`` by default), views and metadata ops
  (``prim.device``, sizes, strides) counting 0 and allocations
  (``empty``) counting 0.  In eager mode every op is a kernel boundary,
  so this is the traffic of an unfused program, where the reference's
  count is that of XLA's fusions.  Host tensors (the gloo exchanges'
  staging buffers) do not count: they are not device-memory traffic;
* ``convert_bytes``: the bytes (in and out) of the ``_to_copy`` calls
  that change the dtype, also inside ``bytes_accessed`` (they are real
  kernels on the card; the reference's were XLA:CPU artifacts and were
  kept out);
* ``collective_bytes``, ``coll_by_op``, ``coll_counts``: the operand
  bytes of each collective, under the reference's names (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``).  A point-to-point send counts as one
  ``collective-permute`` of its bytes (its receive is the peer's side
  of the pair); a broadcast as a ``collective-permute`` on its root
  rank, which sends, and nothing elsewhere; the all-to-all that carries
  ``core/mesh.py::reduce_scatter`` (the sums in rank order) as the
  ``reduce-scatter`` it implements;
* ``coll_by_axis``, ``coll_counts_by_axis``: the same operand bytes and
  calls by the mesh axis whose process group carries them
  (``core/mesh.py::group_axis``; ``"?"`` for a group no mesh axis
  serves), then by kind: the model axis's reduce-scatters and
  all-gathers of activations apart from the data axes' of parameters
  and gradients;
* ``kernels``: the calls of each of the port's kernel ops
  (``repro_torch::topk``, ``repro_torch::merge``), a field of the port's:
  the reference's Pallas calls are custom-calls inside its HLO;
* ``peak_device_bytes`` / ``argument_bytes``: the live bytes of the
  traced device's storages, tracked by storage identity with a
  ``weakref`` finalizer on each storage: the arguments' storages at the
  call, then every storage an op returns, until it is freed;
  ``host_staging_bytes`` the peak of the host storages the step makes
  when it traces a device (the pinned buffers the exchanges stage
  through).

``ops`` and ``op_counts`` (calls by ``namespace.op``) are the port's,
to compare two traces of one step.  ``trip_counts`` has no
counterpart: eager runs every layer and every microbatch, so nothing is
weighted.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")
#: ``c10d`` ops (by name) -> the reference's collective, and which of
#: the op's arguments is its operand
_C10D = {
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    # the port's all-to-all carries core/mesh.py::reduce_scatter (and
    # core/mesh.py::all_to_all, which lays a prefill's caches out for
    # decode and is in no traced step)
    "alltoall_base_": ("reduce-scatter", 1),
    "send": ("collective-permute", 0),
}
#: aten ops that read or write no tensor data
_METADATA = {"sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
             "size", "stride", "numel", "storage_offset", "dim",
             "is_contiguous", "is_same_size", "is_non_overlapping_and_dense",
             "empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "lift_fresh", "_unsafe_view",
             "resize_", "set_", "record_stream", "_local_scalar_dense"}


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    convert_bytes: float = 0.0
    coll_by_op: dict = dataclasses.field(
        default_factory=lambda: {o: 0.0 for o in COLL_OPS})
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: {o: 0 for o in COLL_OPS})
    coll_by_axis: dict = dataclasses.field(default_factory=dict)
    coll_counts_by_axis: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    peak_device_bytes: int = 0
    argument_bytes: int = 0
    host_staging_bytes: int = 0
    ops: int = 0
    op_counts: dict = dataclasses.field(default_factory=dict)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _leaves(obj, seen=None) -> list:
    """Every tensor reachable from ``obj``: modules' parameters and
    buffers, lists, tuples (named too), dicts and dataclasses."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _leaves(v, seen)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _leaves(v, seen)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj)
                for t in _leaves(getattr(obj, f.name), seen)]
    return []


class _Storages:
    """Live bytes of storages of one kind, by storage identity."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}

    def hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._held.pop(key, 0)


class _Counter(TorchDispatchMode):
    def __init__(self, totals: Totals, device: str):
        super().__init__()
        self.t = totals
        self.device = device
        self.dev = _Storages()
        self.host = _Storages()

    def on_device(self, x: torch.Tensor) -> bool:
        return x.device.type == self.device

    def hold(self, tensors) -> None:
        for x in tensors:
            if self.on_device(x):
                self.dev.hold(x)
            elif self.device != "cpu" and x.device.type == "cpu":
                self.host.hold(x)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        t = self.t
        t.ops += 1
        ns = func.namespace
        name = func._opname
        key = f"{ns}.{name}"
        t.op_counts[key] = t.op_counts.get(key, 0) + 1
        outs = _tensors(out)
        self.hold(outs)
        if ns == "c10d":
            coll = _C10D.get(name)
            if name == "broadcast_" and _group_rank(args[1]) == args[2]:
                # (tensors, group, root's group rank, ...): the root sends
                coll = ("collective-permute", 0)
            if coll is not None:
                op, at = coll
                b = sum(_nbytes(x) for x in _tensors(args[at]))
                t.collective_bytes += b
                t.coll_by_op[op] += b
                t.coll_counts[op] += 1
                axis = _axis_of(args)
                by = t.coll_by_axis.setdefault(axis, {})
                by[op] = by.get(op, 0) + b
                n = t.coll_counts_by_axis.setdefault(axis, {})
                n[op] = n.get(op, 0) + 1
            return out
        if ns == "repro_torch":
            t.kernels[name] = t.kernels.get(name, 0) + 1
        elif ns != "aten" or func.is_view or name in _METADATA:
            return out
        moved = sum(_nbytes(x) for x in _tensors((args, kwargs)) + outs
                    if self.on_device(x))
        t.bytes_accessed += moved
        if name == "_to_copy" and outs and args and \
                outs[0].dtype != args[0].dtype:
            t.convert_bytes += moved
        return out


def _axis_of(args) -> str:
    """The mesh axis whose group a ``c10d`` op was handed, or ``"?"``."""
    import torch.distributed as dist
    from repro_torch.core.mesh import group_axis
    for a in args:
        if isinstance(a, (dist.ProcessGroup, torch.ScriptObject)):
            return group_axis(a) or "?"
    return "?"


def _group_rank(pg) -> int:
    """This process's rank in the group a ``c10d`` op was handed (a
    script object under the dispatcher)."""
    import torch.distributed as dist
    if not isinstance(pg, dist.ProcessGroup):
        pg = dist.ProcessGroup.unbox(pg)
    return pg.rank()


def analyze(fn, *args, device: str = "cuda", **kwargs) -> Totals:
    """Run ``fn(*args, **kwargs)`` once and count what it does on
    ``device`` (a device type) as :class:`Totals`."""
    from torch.utils.flop_counter import FlopCounterMode
    totals = Totals()
    counter = _Counter(totals, device)
    counter.hold(_leaves((args, kwargs)))
    totals.argument_bytes = counter.dev.live
    flops = FlopCounterMode(display=False)
    with flops, counter:
        fn(*args, **kwargs)
    totals.flops = float(flops.get_total_flops())
    totals.peak_device_bytes = counter.dev.peak
    totals.host_staging_bytes = counter.host.peak
    return totals
