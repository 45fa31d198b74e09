"""A mesh of peers, held as a tensor axis on one torch device and, where
asked, spread over the ranks of a ``torch.distributed`` group.

The reference runs FD as ``shard_map`` collectives over a JAX device
mesh: each device is a peer and holds one shard of the score axis.  The
port keeps the peers of one process on ONE device as a tensor axis: a
shard of mesh axis ``"model"`` of size P is the view ``(..., P,
n_local)`` of a ``(..., N)`` score tensor, and row p of the peer axis
is what device p holds under ``shard_map``.  The collectives become
tensor operations on that axis (``ppermute``, ``psum``, ``all_gather``,
``axis_index``), and a replicated output is peer 0's row, which is what
``shard_map`` returns for an output that is replicated over the axis.

An axis may also span R ranks of a process group (``Mesh(...,
group=..., ranks=...)``).  An axis of size P over R ranks gives each
rank L = P / R consecutive peers: rank r holds peers ``r*L ...
r*L + L - 1`` as its tensor axis ``(..., L, n_local)``.  Each collective
keeps its JAX meaning: a ``ppermute`` pair whose two peers sit on one
rank stays an ``index_select``, the pairs that cross ranks become one
message per (rank -> rank) pair and round, all sent and received in one
``batch_isend_irecv``; ``psum`` gathers every peer's term and sums them
in peer order, as one process does; ``all_gather`` concatenates the
ranks in peer order.
Each axis over more than one rank and fewer than all gets one subgroup
per combination of the other axes' rank coordinates, made by
``dist.new_group`` with the group's own backend when the mesh is built,
by every rank in the same order.  One rank per axis (the default) is
the one-process mesh, whose code path and bits are unchanged.

The model-axis collectives of the LM's products split over model ranks
(``copy_to_model``, ``reduce_from_model``, ``gather_from_model``,
``slice_to_model``) are autograd functions, each with its conjugate
backward (Megatron's f / g pairs).  Their sum (:func:`all_reduce`) is a
reduce-scatter in rank order followed by an all-gather: each chunk is
summed by one rank over ranks 0 ... n-1 in order and then sent to every
rank, so every rank holds the same bits, at 2 (n - 1) / n of the
operand sent where ``psum``'s gather sends (n - 1) times it.  Over an
axis within one rank each of them is the identity.  The decode over a
cache whose sequence is cut over the model ranks adds their maximum
(``max_over_model``) and an exchange of blocks (``all_to_all``, heads
for sequence blocks), which have no gradient.

Which backend: gloo.  NCCL refuses two ranks on one card, and a machine
with one card then runs its ranks as processes that share it.  gloo's
send and receive take host tensors, so every exchange of CUDA tensors
is staged through pinned host buffers, after the producing stream is
synchronised (a fake tensor, which ``launch/dryrun.py`` runs over the
``fake`` backend's world, has nothing to wait for).  The mesh counts
the payload bytes this rank delivers to other ranks
(``Mesh.sent_bytes``, and by axis ``Mesh.sent_by_axis``): the traffic
the paper counts, measured at a process boundary.

A ``"data"`` mesh axis shards only the batch of queries; every
collective is elementwise per batch row, so within one process it
changes no bit and the port keeps the batch whole.  Over ranks, each
data rank takes its rows of the batch (``core/fd.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch


def resolve_device(device=None, what: str = "this engine") -> torch.device:
    """The device to run on: ``"cuda"`` unless the caller names another.

    With ``device=None`` and no CUDA device this raises — the port never
    carries on on the CPU unasked.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path")
        device = "cuda"
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: ``size`` peers in all over
    ``ranks`` ranks, this rank at position ``index`` along it holding
    ``local`` peers from ``offset``.  ``group`` is the axis's process
    group and ``peers[j]`` the global rank at position j (both None
    for an axis within one rank)."""

    name: str
    size: int
    ranks: int
    index: int
    group: object
    peers: Optional[Tuple[int, ...]]
    mesh: "Mesh"

    @property
    def local(self) -> int:
        return self.size // self.ranks

    @property
    def offset(self) -> int:
        return self.index * self.local


class Mesh:
    """Named mesh axes over peers held on one ``device``.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``
    does.  ``group`` (a ``torch.distributed`` process group) and
    ``ranks`` (how many of its ranks each axis spans) spread the peers
    over processes: the group's ranks are laid out row-major over
    ``ranks``, whose product must be the group's size and each entry of
    which must divide its axis.  ``ranks`` defaults to all of the
    group's ranks on the first axis, and to one rank per axis without a
    group.  Building a mesh over ranks is itself collective: every rank
    of the group builds it with the same arguments.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device, *, group=None, ranks: Optional[Sequence[int]]
                 = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match "
                             f"axis names {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {tuple(axis_names)}")
        if any(int(s) < 1 for s in shape):
            raise ValueError(f"mesh axis sizes must be >= 1, got "
                             f"{tuple(shape)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(
            zip(self.axis_names, (int(s) for s in shape)))
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # the device a tensor made on "cuda" reports
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.sent_bytes = 0
        self.sent_by_axis: Dict[str, int] = {n: 0 for n in self.axis_names}
        self._axes = self._layout(group, ranks)

    def _layout(self, group, ranks) -> Dict[str, Axis]:
        """Check the rank layout (raising before any collective) and
        make each axis's subgroups."""
        if ranks is None:
            ranks = (1,) * len(self.axis_names)
            if group is not None:
                ranks = (_group_size(group),) + ranks[1:]
        ranks = tuple(int(r) for r in ranks)
        if len(ranks) != len(self.axis_names) or min(ranks) < 1:
            raise ValueError(f"ranks {ranks} do not match axes "
                             f"{self.axis_names}")
        for name, r in zip(self.axis_names, ranks):
            if self.shape[name] % r:
                raise ValueError(
                    f"{r} ranks do not divide mesh axis {name!r} of size "
                    f"{self.shape[name]}")
        world = math.prod(ranks)
        if world > 1 and group is None:
            raise ValueError(f"ranks {ranks} need a process group")
        if group is not None and _group_size(group) != world:
            raise ValueError(f"ranks {ranks} span {world} ranks, the group "
                             f"has {_group_size(group)}")
        self.ranks: Dict[str, int] = dict(zip(self.axis_names, ranks))
        if world == 1:
            self.group, self.rank = None, 0
            return {name: Axis(name, self.shape[name], 1, 0, None, None,
                               self) for name in self.axis_names}
        import torch.distributed as dist
        self.group, self.rank = group, dist.get_rank(group)
        members = dist.get_process_group_ranks(group)
        coord = _unravel(self.rank, ranks)
        axes = {}
        for a, name in enumerate(self.axis_names):
            if ranks[a] == 1:
                axes[name] = Axis(name, self.shape[name], 1, 0, None, None,
                                  self)
                continue
            mine = None
            others = [range(r) if b != a else (0,)
                      for b, r in enumerate(ranks)]
            for base in itertools.product(*others):
                line = tuple(
                    members[_ravel(base[:a] + (j,) + base[a + 1:], ranks)]
                    for j in range(ranks[a]))
                if ranks[a] == world:
                    sub = group
                else:        # every rank makes every group, in this order
                    sub = dist.new_group(ranks=list(line),
                                         backend=dist.get_backend(group))
                if base[:a] + base[a + 1:] == coord[:a] + coord[a + 1:]:
                    mine = (sub, line)
                    _GROUP_AXIS[_group_name(sub)] = name
            axes[name] = Axis(name, self.shape[name], ranks[a], coord[a],
                              mine[0], mine[1], self)
            # a first collective on every axis group: later point-to-point
            # rounds may then involve only some of its ranks
            dist.barrier(group=mine[0])
        return axes

    def count_sent(self, axis: Axis, n: int) -> None:
        """Add ``n`` bytes this rank delivered over ``axis``."""
        self.sent_bytes += n
        self.sent_by_axis[axis.name] += n

    def axis(self, name: str) -> Axis:
        """The :class:`Axis` ``name`` as this rank sees it."""
        if name not in self._axes:
            raise ValueError(f"mesh {self} has no axis {name!r}")
        return self._axes[name]

    @property
    def multi_rank(self) -> bool:
        """True when some axis spans more than one rank."""
        return self.group is not None

    def __repr__(self) -> str:
        if self.group is None:
            return f"Mesh({self.shape}, device={self.device})"
        return (f"Mesh({self.shape}, ranks={self.ranks}, rank={self.rank}, "
                f"device={self.device})")


#: the mesh axis each rank-spanning axis group serves, by group name (the
#: last mesh built names it), for ``roofline/trace.py``'s count by axis
_GROUP_AXIS: Dict[str, str] = {}


def _group_name(group) -> str:
    import torch.distributed as dist
    if not isinstance(group, dist.ProcessGroup):
        group = dist.ProcessGroup.unbox(group)
    return group.group_name


def group_axis(group) -> Optional[str]:
    """The mesh axis ``group`` (a process group, or the script object a
    ``c10d`` op is handed) serves, or None."""
    return _GROUP_AXIS.get(_group_name(group))


def _group_size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def _unravel(i: int, dims: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for d in reversed(dims):
        out.append(i % d)
        i //= d
    return tuple(reversed(out))


def _ravel(coord: Tuple[int, ...], dims: Tuple[int, ...]) -> int:
    i = 0
    for c, d in zip(coord, dims):
        i = i * d + c
    return i


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device=None, group=None, ranks=None) -> Mesh:
    """The port's ``jaxcompat.make_mesh``: a :class:`Mesh` on ``device``
    (``"cuda"`` by default; raises without one unless ``device`` is
    given), over ``group``'s ranks laid out by ``ranks`` when given."""
    return Mesh(axis_shapes, axis_names, resolve_device(device, "make_mesh"),
                group=group, ranks=ranks)


@dataclasses.dataclass(frozen=True)
class Permutation:
    """One ``ppermute`` round as index tensors on the mesh's device.

    ``src[p]`` is the local peer that local peer p receives from;
    ``received[p]`` is False for a peer that receives nothing from a
    peer of its own rank (its ``src`` is 0 then).  Over ranks,
    ``sends`` holds ``(j, local sources)`` for each rank position j of
    the axis that this rank sends to, and ``recvs`` ``(j, local
    destinations)`` for each it receives from, both in the order of the
    round's pairs: a message carries the lists of those peers stacked.
    """

    src: torch.Tensor
    received: torch.Tensor
    sends: tuple = ()
    recvs: tuple = ()


def permutation(pairs, size: int, device, axis: Optional[Axis] = None
                ) -> Permutation:
    """The index tensors of a ``jax.lax.ppermute`` list of (src, dst)
    over an axis of ``size`` peers (``axis``: over ranks)."""
    seen = set()
    for _, d in pairs:
        if d in seen:
            raise ValueError(f"peer {d} receives twice in {pairs}")
        seen.add(d)
    local, off, me = size, 0, 0
    if axis is not None and axis.ranks > 1:
        local, off, me = axis.local, axis.offset, axis.index
    src = [0] * local
    received = [False] * local
    sends: Dict[int, list] = {}
    recvs: Dict[int, list] = {}
    for s, d in pairs:
        rs, rd = s // local, d // local
        if rd == me and rs == me:
            src[d - off], received[d - off] = s - off, True
        elif rd == me:
            recvs.setdefault(rs, []).append(d - off)
        elif rs == me:
            sends.setdefault(rd, []).append(s - off)

    def index(table):
        return tuple((j, torch.tensor(v, dtype=torch.int64, device=device))
                     for j, v in sorted(table.items()))
    return Permutation(
        torch.tensor(src, dtype=torch.int64, device=device),
        torch.tensor(received, dtype=torch.bool, device=device),
        index(sends), index(recvs))


def axis_index(size: int, device, axis: Optional[Axis] = None
               ) -> torch.Tensor:
    """Every local peer's index along the axis (``jax.lax.axis_index``),
    int32: ``offset + arange(size)`` over ranks."""
    off = 0 if axis is None else axis.offset
    return torch.arange(off, off + size, dtype=torch.int32, device=device)


def ppermute(x: torch.Tensor, perm: Permutation) -> torch.Tensor:
    """``jax.lax.ppermute`` over the peer axis (dim -2) of ``x`` within
    one rank: peer p gets the row of ``perm.src[p]``; peers that
    receive nothing get zeros, as in JAX."""
    got = x.index_select(-2, perm.src)
    return torch.where(perm.received[:, None], got, 0)


def ppermute_all(xs: Sequence[torch.Tensor], perm: Permutation,
                 axis: Optional[Axis] = None) -> tuple:
    """:func:`ppermute` of each of ``xs`` (all ``(..., L, m_i)`` with one
    leading shape) in one round: within a rank by ``index_select``, and
    over ranks as one message per (rank -> rank) pair carrying every
    tensor's rows of that pair's peers."""
    outs = tuple(ppermute(x, perm) for x in xs)
    if perm.sends or perm.recvs:
        _exchange(axis, perm, xs, outs)
    return outs


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t`` for gloo, which may write into it
    (pinned when staged from the card; the caller synchronises before
    gloo reads it)."""
    if t.device.type == "cpu":
        return t.clone(memory_format=torch.contiguous_format)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _host_buffer(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")


def _synchronize(t: torch.Tensor) -> None:
    """Wait for the copies from ``t``'s device to the staging buffers (a
    fake tensor has no stream to wait for)."""
    from torch._subclasses.fake_tensor import FakeTensor
    if t.device.type == "cuda" and not isinstance(t, FakeTensor):
        torch.cuda.current_stream(t.device).synchronize()


def _pack(parts) -> torch.Tensor:
    """Tensors of one leading shape as the bytes of their last dims,
    concatenated: ``(..., sum(m_i * itemsize_i))`` uint8."""
    return torch.cat([p.contiguous().view(torch.uint8) for p in parts], -1)


def _unpack(buf: torch.Tensor, like) -> list:
    """The inverse of :func:`_pack` for tensors shaped as ``like``'s
    last dims and dtypes."""
    out, at = [], 0
    for x in like:
        width = x.shape[-1] * x.element_size()
        out.append(buf[..., at:at + width].contiguous().view(x.dtype))
        at += width
    return out


def _exchange(axis: Axis, perm: Permutation, xs, outs) -> None:
    """The cross-rank part of a round: send each rank its peers' rows,
    receive ours into ``outs`` (in place)."""
    import torch.distributed as dist
    dev = xs[0].device
    lead = xs[0].shape[:-2]
    row_bytes = sum(x.shape[-1] * x.element_size() for x in xs)
    ops, got = [], []
    for j, idx in perm.sends:
        host = _to_host(_pack([x.index_select(-2, idx) for x in xs]))
        ops.append(dist.P2POp(dist.isend, host, axis.peers[j], axis.group))
        axis.mesh.count_sent(axis, host.numel())
    _synchronize(xs[0])
    for j, idx in perm.recvs:
        buf = _host_buffer(lead + (len(idx), row_bytes), torch.uint8, dev)
        ops.append(dist.P2POp(dist.irecv, buf, axis.peers[j], axis.group))
        got.append((idx, buf))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for idx, buf in got:
        for out, part in zip(outs, _unpack(buf.to(dev, non_blocking=True),
                                           xs)):
            out.index_copy_(-2, idx, part)


def psum(x: torch.Tensor, dim: int = -2,
         axis: Optional[Axis] = None) -> torch.Tensor:
    """``jax.lax.psum`` over the peer axis: the sum over ``dim``, in the
    input dtype.  The result is the same for every peer, so the peer
    axis is dropped.

    Bits as in JAX: the sum starts from +0.0, so -0.0 terms alone give
    +0.0, except over an axis of one peer, where ``psum`` is the
    identity.  Over ranks every rank gathers all P terms in peer order
    and sums them as one process does: a sum of two or more non-zero
    terms (the retrieval's, where peers' lists tie differently) then
    rounds as on one process, which an ``all_reduce`` of per-rank sums
    does not promise.
    """
    if axis is not None and axis.ranks > 1:
        x = gather_dim(x, axis, dim)
    if x.shape[dim] == 1:
        return x.select(dim, 0)
    return x.sum(dim=dim, dtype=x.dtype)


def broadcast_all(xs: Sequence[torch.Tensor], axis: Axis) -> list:
    """The tensors of the axis's first rank on every rank of ``axis``,
    in one message (the others' ``xs`` give only shapes and dtypes)."""
    import torch.distributed as dist
    dev = xs[0].device
    host = _to_host(_pack(xs))
    _synchronize(xs[0])
    dist.broadcast(host, src=axis.peers[0], group=axis.group)
    if axis.index == 0:
        axis.mesh.count_sent(axis, host.numel() * (axis.ranks - 1))
    return _unpack(host.to(dev, non_blocking=True), xs)


def gather_dim(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated on ``dim``, rank 0
    first (``x`` has one shape on every rank)."""
    if axis is None or axis.ranks == 1:
        return x
    import torch.distributed as dist
    host = _to_host(x)
    _synchronize(x)
    parts = [torch.empty_like(host) for _ in range(axis.ranks)]
    dist.all_gather(parts, host, group=axis.group)
    axis.mesh.count_sent(axis, host.numel() * host.element_size() * (
        axis.ranks - 1))
    return torch.cat(parts, dim).to(x.device, non_blocking=True)


def all_gather(x: torch.Tensor, axis: Optional[Axis] = None
               ) -> torch.Tensor:
    """``jax.lax.all_gather(..., axis=-1, tiled=True)`` of per-peer rows
    ``(..., L, m)``: the ``(..., P * m)`` concatenation, peer 0 first."""
    flat = x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))
    return gather_dim(flat, axis, -1)


# --------------------------------------------------------------------------
# sums in rank order and the model-axis collectives
# --------------------------------------------------------------------------

def _spans(axis: Optional[Axis]) -> bool:
    return axis is not None and axis.ranks > 1


def reduce_scatter(x: torch.Tensor, axis: Axis, dim: int = 0,
                   op: str = "sum") -> torch.Tensor:
    """This rank's block of ``dim`` (block ``axis.index`` of
    ``axis.ranks`` equal ones) of ``x`` reduced over the axis's ranks:
    each rank sends every other its block (one all-to-all) and reduces
    the n blocks it receives in rank order, ``stack(...).sum(0)`` as
    :func:`psum` sums them (``op="max"``: their maximum).  Sends (n - 1)
    / n of ``x``."""
    import torch.distributed as dist
    n = axis.ranks
    lead = x.movedim(dim, 0)
    if lead.shape[0] % n:
        raise ValueError(f"a dim of {lead.shape[0]} does not split over "
                         f"{n} ranks")
    host = _to_host(lead)
    _synchronize(x)
    got = torch.empty_like(host)
    dist.all_to_all_single(got, host, group=axis.group)
    axis.mesh.count_sent(axis, host.numel() * host.element_size()
                         * (n - 1) // n)
    got = got.to(x.device, non_blocking=True)
    parts = got.view((n, lead.shape[0] // n) + tuple(lead.shape[1:]))
    out = (parts.sum(0, dtype=x.dtype) if op == "sum"
           else parts.amax(0))
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, axis: Optional[Axis],
               op: str = "sum") -> torch.Tensor:
    """``x`` summed over the axis's ranks (``op="max"``: their
    maximum), the same bits on every rank: :func:`reduce_scatter` of
    the flattened ``x`` (zero-padded to a whole number of chunks), then
    an all-gather of the chunks.  Sends 2 (n - 1) / n of ``x``.  The
    identity over an axis within one rank."""
    if not _spans(axis):
        return x
    n = axis.ranks
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    whole = gather_dim(reduce_scatter(flat, axis, 0, op), axis, 0)
    return whole[:x.numel()].view(x.shape)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.size = axis, dim, x.shape[dim]
        return gather_dim(x.contiguous(), axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.size,
                        ctx.size), None, None


class _SliceToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        part = x.shape[dim] // axis.ranks
        return x.narrow(dim, axis.index * part, part).contiguous()

    @staticmethod
    def backward(ctx, g):
        # the zero-padded slices summed over the ranks: their concatenation
        return gather_dim(g.contiguous(), ctx.axis, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The input of a product split over the model ranks: the identity,
    whose gradient is summed over the ranks (:func:`all_reduce`)."""
    return _CopyToModel.apply(x, axis) if _spans(axis) else x


def reduce_from_model(x: torch.Tensor,
                      axis: Optional[Axis]) -> torch.Tensor:
    """The ranks' partial results summed (:func:`all_reduce`); the
    gradient passes as it is."""
    return _ReduceFromModel.apply(x, axis) if _spans(axis) else x


def gather_from_model(x: torch.Tensor, axis: Optional[Axis],
                      dim: int) -> torch.Tensor:
    """The ranks' blocks concatenated on ``dim`` in rank order; the
    gradient is this rank's block of it (every rank computes the same
    loss from the gathered tensor, so it is not summed)."""
    return _GatherFromModel.apply(x, axis, dim) if _spans(axis) else x


def slice_to_model(x: torch.Tensor, axis: Optional[Axis],
                   dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` of a tensor every rank holds whole;
    the gradient is the sum of the ranks' zero-padded blocks, which is
    their concatenation."""
    return _SliceToModel.apply(x, axis, dim) if _spans(axis) else x


def max_over_model(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The elementwise maximum of the ranks' ``x`` (:func:`all_reduce`
    with ``op="max"``: exact, so every rank holds the same bits); no
    gradient (the decode's softmax over a sequence cut over the ranks
    reads it)."""
    return all_reduce(x, axis, op="max") if _spans(axis) else x


def all_to_all(x: torch.Tensor, axis: Optional[Axis], split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """``x`` cut into ``axis.ranks`` equal blocks of ``split_dim``, block
    j sent to the axis's rank j, and the blocks this rank receives
    concatenated on ``cat_dim`` in rank order (``jax.lax.all_to_all``
    with ``tiled=True``): one ``dist.all_to_all_single`` (gloo has no
    list form) of the blocks stacked, (n - 1) / n of ``x`` sent.  The
    identity over an axis within one rank."""
    if not _spans(axis):
        return x
    import torch.distributed as dist
    n = axis.ranks
    if x.shape[split_dim] % n:
        raise ValueError(f"a dim of {x.shape[split_dim]} does not split "
                         f"over {n} ranks")
    host = _to_host(torch.stack(x.chunk(n, split_dim)))
    _synchronize(x)
    got = torch.empty_like(host)
    dist.all_to_all_single(got, host, group=axis.group)
    axis.mesh.count_sent(axis, host.numel() * host.element_size()
                         * (n - 1) // n)
    got = got.to(x.device, non_blocking=True)
    return torch.cat(got.unbind(0), cat_dim)
