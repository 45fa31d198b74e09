"""Parameter partition rules and their placement over ranks.

The rules are the reference's (``src/repro/optim/sharding.py``): tensor
parallelism over the ``model`` axis for every dim that divides evenly
(attention heads only when ``n_heads % model_size == 0`` and not MLA,
FFN hidden, whole experts, RG-LRU width, vocabulary), ZeRO-3-style
FSDP over ``("pod", "data")`` on a remaining dim, 1-D leaves
replicated unless model-sharded by construction.

A spec is a plain tuple with one entry a dimension: ``None``, an axis
name, or a tuple of axis names (a tuple of one name is written as the
name, as ``PartitionSpec`` normalises it).  Specs are keyed on the
port's parameter names (``embed``, ``w_lm``, ``pos_embed``,
``layers.<i>.mixer.w_q``, ``layers.<i>.ffn.shared.w_up``,
``enc.layers.<i>.cross.w_k``, ...).  The port keeps one block a layer,
so no leaf has the reference's leading ``groups`` dim: each spec is
the reference's with that ``None`` dropped, and layer i's kind is
``cfg.mixer_pattern[i % len(cfg.mixer_pattern)]``, what ``_classify``
reads from the ``groups`` slot or the ``rem`` index.  The functions
take an ``LM`` or a mapping ``{name: shape}`` (so the specs of every
full-size arch come without allocating it), and a mesh shape from a
port :class:`~repro_torch.core.mesh.Mesh` or a dict.

Placement over ranks (``shard_leaf``, ``gather_leaf``,
``reduce_leaf``; the first two over the spec's axes or those named):
each rank-spanning axis a spec names cuts that
dimension into equal blocks in rank-coordinate order, which is
``NamedSharding``'s layout where each rank holds one peer of an axis;
an axis held as virtual peers inside one rank leaves the dimension
whole, so on a one-process mesh every leaf is whole and placement
changes nothing.  The decode state's layout is
:func:`cache_seq_block`'s: each attention cache's sequence dim over
the model ranks where it cuts it.  That is :func:`decode_state_specs`'
placement but for a stacked window cache's ``pos_slots`` (reference
fault 10), which the port cuts as its ``k``'s window dim.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

FSDP_AXES = ("pod", "data")
MODEL = "model"


def _mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a port ``Mesh`` or of a dict."""
    return dict(mesh.shape if hasattr(mesh, "shape") else mesh)


def _axes_size(mesh_shape: dict, axes) -> int:
    return math.prod(mesh_shape.get(a, 1) for a in axes)


def _fit(axes, dim: int, mesh_shape: dict):
    """Return ``axes`` (str | tuple | None) trimmed so dim %% size == 0."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if dim % mesh_shape.get(axes, 1) == 0 else None
    # tuple: drop leading axes until it fits ("pod","data") -> ("data",)
    t = tuple(a for a in axes if a in mesh_shape)
    while t and dim % _axes_size(mesh_shape, t) != 0:
        t = t[1:]
    return t if t else None


def _entry(axes):
    """A spec entry as ``PartitionSpec`` holds it: a tuple of one axis
    is that axis's name."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _pad(spec, ndim: int) -> tuple:
    """``spec`` with ``None`` up to one entry a dimension."""
    return tuple(spec) + (None,) * (ndim - len(spec))


def _mk(spec_axes, shape, mesh_shape) -> tuple:
    fitted = [_entry(_fit(ax, shape[d], mesh_shape))
              for d, ax in enumerate(spec_axes)]
    return _pad(fitted, len(shape))


def fsdp_axes(mesh_shape: dict):
    return tuple(a for a in FSDP_AXES if a in mesh_shape)


def batch_axes(mesh_shape: dict):
    """Axes the global batch is sharded over."""
    return tuple(a for a in FSDP_AXES if a in mesh_shape)


# --------------------------------------------------------------------------
# rule table
# --------------------------------------------------------------------------

def heads_split(cfg, msize: int) -> bool:
    """The rules split attention heads over ``msize`` model peers: the
    head count divides, and the attention is not MLA."""
    return cfg.n_heads % msize == 0 and cfg.attn_kind != "mla"


def kv_split(cfg, msize: int) -> bool:
    """The rules split the KV heads too: the heads split and the KV
    head count divides."""
    return heads_split(cfg, msize) and cfg.n_kv_heads % msize == 0


def splits_over_model(kind: str, name: str, cfg, msize: int,
                      dim_size: int) -> bool:
    """Whether the rules put ``model`` on leaf ``name`` of a ``kind``
    block for ``msize`` model peers, where the dim they would cut has
    ``dim_size`` entries (a size the caller takes from the config):
    the rule table's own answer, with its fit."""
    axes = (_top_level_rule(name, ()) if kind == "top"
            else _rules_for(kind, name, cfg, {MODEL: msize}, 3))
    return MODEL in axes and dim_size % msize == 0


def _rules_for(kind: str, name: str, cfg, mesh_shape: dict, ndim: int):
    """Logical axes (pre-fit) for a leaf ``name`` inside a ``kind`` block
    (the reference's table, unchanged)."""
    msize = mesh_shape.get(MODEL, 1)
    F = fsdp_axes(mesh_shape)
    attn_tp = heads_split(cfg, msize)
    kv_tp = kv_split(cfg, msize)

    if kind == "attn":
        if name == "w_q":
            return (F, MODEL) if attn_tp else (F, None)
        if name in ("w_k", "w_v"):
            return (F, MODEL) if kv_tp else (F, None)
        if name == "w_o":
            return (MODEL, F) if attn_tp else (F, None)
        if name == "b_q":
            return (MODEL,) if attn_tp else (None,)
        if name in ("b_k", "b_v"):
            return (MODEL,) if kv_tp else (None,)
        # MLA projections: latent ranks don't head-align; ZeRO only
        if name in ("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv"):
            return (F, None)
    if kind == "rwkv":
        if name in ("w_r", "w_k", "w_v", "w_g", "w_o", "lora_wa"):
            return (F, None)
        if name == "lora_wb":
            return (None, F)
    if kind == "rglru":
        if name in ("w_x", "w_gate"):
            return (F, MODEL)
        if name == "conv_w":
            return (None, MODEL)
        if name in ("conv_b", "lam"):
            return (MODEL,)
        if name in ("w_a", "w_i"):
            return (MODEL, None, None)
        if name == "w_out":
            return (MODEL, F)
    if kind == "ffn":
        if name in ("w_gate", "w_up", "w_k"):      # w_k = rwkv cmix up-proj
            return (F, MODEL)
        if name == "b_up":
            return (MODEL,)
        if name in ("w_down", "w_v"):              # w_v = rwkv cmix down-proj
            return (MODEL, F)
        if name == "w_r":                          # cmix receptance
            return (F, None)
    if kind == "moe":
        # whole experts over the model axis (expert parallel)
        if name == "router":
            return (None, None)
        if name in ("w_gate", "w_up", "w_down"):
            return (MODEL, None, None)
    return (None,) * ndim


def _classify(tokens, cfg):
    """(kind, name) of a parameter named ``tokens`` (its name split at
    the dots): the reference's ``_classify`` without the scan dim."""
    name = tokens[-1]
    kind = "attn"
    if "enc" not in tokens and "layers" in tokens:
        i = int(tokens[tokens.index("layers") + 1])
        kind = cfg.mixer_pattern[i % len(cfg.mixer_pattern)]
    if "cross" in tokens:
        kind = "attn"
    if "ffn" in tokens:
        if "shared" in tokens:
            kind = "ffn"
        elif cfg.moe is not None:
            kind = "moe"
        else:
            kind = "ffn"
    if "mixer" not in tokens and "ffn" not in tokens \
            and "cross" not in tokens:
        kind = "top"
    return kind, name


def _top_level_rule(name: str, F) -> tuple:
    if name == "embed":
        return (MODEL, F)
    if name == "w_lm":
        return (F, MODEL)
    if name == "pos_embed":
        return (None, F)
    return ()


def _top_level_spec(name: str, shape, mesh_shape) -> tuple:
    rule = _top_level_rule(name, fsdp_axes(mesh_shape))
    if not rule:
        return (None,) * len(shape)
    return _mk(rule, shape, mesh_shape)


def param_shapes(params) -> Dict[str, Tuple[int, ...]]:
    """``{name: shape}`` of an ``LM`` (its ``named_parameters``) or of a
    mapping of names to shapes or tensors."""
    if hasattr(params, "named_parameters"):
        return {n: tuple(p.shape) for n, p in params.named_parameters()}
    return {n: tuple(getattr(s, "shape", s)) for n, s in params.items()}


def param_specs(params, cfg, mesh) -> Dict[str, tuple]:
    """``{name: spec}`` for every parameter of ``params``."""
    mesh_shape = _mesh_shape(mesh)
    out = {}
    for name, shape in param_shapes(params).items():
        kind, leaf = _classify(name.split("."), cfg)
        if kind == "top":
            out[name] = (_top_level_spec(leaf, shape, mesh_shape)
                         if leaf in ("embed", "w_lm", "pos_embed")
                         else (None,) * len(shape))
            continue
        axes = _rules_for(kind, leaf, cfg, mesh_shape, len(shape))
        out[name] = _mk(axes, shape, mesh_shape)
    return out


def opt_state_specs(params, cfg, mesh) -> Dict[str, tuple]:
    """Optimizer-state (and gradient-accumulator) specs: the parameter
    specs plus ZeRO-1 data-sharding of the MoE expert dims that the
    parameters keep replicated.  The dry-run's; the port's training
    places the moments as the parameters, as the reference's
    ``launch/train.py`` does."""
    mesh_shape = _mesh_shape(mesh)
    F = fsdp_axes(mesh_shape)
    base = param_specs(params, cfg, mesh)
    if cfg.moe is None or not F:
        return base
    shapes = param_shapes(params)
    out = dict(base)
    for name, spec in base.items():
        toks = name.split(".")
        if "ffn" in toks and "shared" not in toks and \
                toks[-1] in ("w_gate", "w_up", "w_down"):
            # shard the D dim over the data axes (E stays model-sharded)
            d_dim = 1 if toks[-1] in ("w_gate", "w_up") else 2
            core = list(spec)
            core[d_dim] = _entry(_fit(F, shapes[name][d_dim], mesh_shape))
            out[name] = tuple(core)
    return out


# --------------------------------------------------------------------------
# decode-state specs (KV caches & recurrent states)
# --------------------------------------------------------------------------

def decode_state_specs(state, cfg, mesh, *, s_max: int):
    """Cache specs: batch over the data axes; the long sequence (or
    window) dim of attention caches over ``model``.  ``state`` is a
    ``DecodeState`` (or its list of per-layer caches); the result has
    its structure, a spec in place of each tensor and ``()`` for the
    position.

    The reference's rule runs on its stacked caches: a leaf of a layer
    in a scanned group has a leading groups dim, its batch dim is dim 1,
    and its 1-D rule never applies.  So a layer the reference stacks
    (``i < (n_layers // g) * g``) is given its spec on the shape with
    that dim put back, then dropped.  The ``pos_slots`` of a stacked
    window cache is 2-D there, and its window dim takes the batch axes
    (the reference's ``name == "pos_slots"`` test reads a dict key,
    and ``pos_slots`` is a field of a ``NamedTuple``, so the test never
    holds); the port gives it the same spec.
    """
    mesh_shape = _mesh_shape(mesh)
    baxes = batch_axes(mesh_shape)
    bsize = _axes_size(mesh_shape, baxes)
    msize = mesh_shape.get(MODEL, 1)
    seq_dims = {s_max, cfg.local_window, cfg.encoder_seq} - {0}

    def one(shape, stacked: bool) -> tuple:
        shape = ((1,) if stacked else ()) + tuple(shape)
        if len(shape) == 1:
            return (MODEL,) if shape[0] in seq_dims and \
                shape[0] % msize == 0 else (None,)
        if not shape:
            return ()
        spec = [None] * len(shape)
        b_dim = 1 if stacked else 0
        if len(shape) > b_dim and baxes and shape[b_dim] % bsize == 0 \
                and shape[b_dim] >= bsize:
            spec[b_dim] = _entry(baxes)
        for d in range(b_dim + 1, len(shape)):
            if shape[d] in seq_dims and shape[d] % msize == 0:
                spec[d] = MODEL
                break
        return tuple(spec[b_dim:]) if stacked else tuple(spec)

    def walk(node, stacked):
        if torch.is_tensor(node) or hasattr(node, "shape") and \
                not isinstance(node, tuple):
            return one(node.shape, stacked)
        if isinstance(node, dict):
            return {k: walk(v, stacked) for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(*(walk(v, stacked) for v in node))
        raise TypeError(f"decode_state_specs: no leaf of type {type(node)}")

    caches = state.caches if hasattr(state, "caches") else state
    n_stacked = len(caches) // len(cfg.mixer_pattern) * len(
        cfg.mixer_pattern)
    out = [walk(c, i < n_stacked) for i, c in enumerate(caches)]
    if hasattr(state, "caches"):
        return type(state)(out, ())
    return out


def cache_seq_block(dim: int, mesh) -> Optional[Tuple[int, int]]:
    """(start, length) of this rank's block of an attention cache's
    sequence dim of ``dim`` entries (S_max, a window's W slots, or the
    encoder's frames), or None where the rank holds it whole: the port's
    decode layout.  :func:`decode_state_specs`'s rule puts ``model`` on
    that dim where ``dim`` divides the model axis's size; the dim is then
    cut into one block a model rank (:func:`_block_range`), so it stays
    whole on one process and over an axis of virtual peers within a
    rank.  ``models/transformer.py::init_block_cache``,
    ``launch/serve.py::state_from_prefill`` and, through them, the dry
    run read this rule."""
    if mesh is None or MODEL not in mesh.shape or dim % mesh.shape[MODEL]:
        return None
    return _block_range(MODEL, mesh, dim)


# --------------------------------------------------------------------------
# input specs
# --------------------------------------------------------------------------

def input_specs_pytree(batch_like, mesh, *, batch_dim: int = 0):
    """Shard every input leaf's batch dim over the data axes (replicate
    if the batch doesn't divide).  ``batch_like``: ``{key: array or
    tensor or shape}``."""
    mesh_shape = _mesh_shape(mesh)
    baxes = batch_axes(mesh_shape)
    bsize = _axes_size(mesh_shape, baxes)

    def one(leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        spec = [None] * len(shape)
        if len(shape) > batch_dim and shape[batch_dim] % bsize == 0 \
                and baxes:
            spec[batch_dim] = _entry(baxes)
        return tuple(spec)

    return {k: one(v) for k, v in batch_like.items()}


# --------------------------------------------------------------------------
# placement over ranks
# --------------------------------------------------------------------------

def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block_range(entry, mesh, dim_size: int) -> Optional[Tuple[int, int]]:
    """(start, length) of this rank's part of a dim of ``dim_size`` cut
    by ``entry``'s axes, or None where the rank holds it whole.  Only
    the axes that span ranks cut: the dim falls into one block a rank
    of them, numbered row-major over them in the entry's order by the
    rank's coordinates, which is ``NamedSharding``'s layout where each
    rank holds one peer; an axis of virtual peers within the rank
    leaves the dim whole."""
    axes = [mesh.axis(a) for a in _names(entry)
            if a in mesh.shape and mesh.axis(a).ranks > 1]
    if not axes:
        return None
    n = math.prod(ax.ranks for ax in axes)
    if dim_size % n:
        raise ValueError(f"dim of {dim_size} does not divide into {n} "
                         f"blocks over {_names(entry)}")
    index = 0
    for ax in axes:
        index = index * ax.ranks + ax.index
    part = dim_size // n
    return index * part, part


def global_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The whole leaf's shape from this rank's block ``shape``."""
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        out.append(n * math.prod(mesh.axis(a).ranks for a in _names(entry)
                                 if a in mesh.shape))
    return tuple(out)


def _cut_axes(entry, axes) -> tuple:
    """The axes of ``entry`` that are in ``axes`` (all of them where
    ``axes`` is None)."""
    return tuple(a for a in _names(entry) if axes is None or a in axes)


def shard_leaf(x: torch.Tensor, spec, mesh, axes=None) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` over the rank-spanning
    axes of ``spec`` among ``axes`` (all of them by default; serving
    passes ``("model",)`` to keep the model block whole over the data
    axes); ``x`` itself when none spans ranks."""
    for d in range(x.dim()):
        entry = spec[d] if d < len(spec) else None
        r = _block_range(_cut_axes(entry, axes) or None, mesh,
                         x.shape[d])
        if r is not None:
            x = x.narrow(d, *r)
    return x


def gather_leaf(block: torch.Tensor, spec, mesh, axes=None) -> torch.Tensor:
    """The leaf gathered from every rank's block over the rank-spanning
    axes of ``spec`` among ``axes`` (all of them by default; the train
    step passes the data axes, so that a model block stays one):
    ``core/mesh.py::gather_dim`` over each such axis of each dim, the
    innermost axis first, so that the blocks join in rank-coordinate
    order."""
    from repro_torch.core.mesh import gather_dim
    x = block
    for d in range(block.dim()):
        entry = spec[d] if d < len(spec) else None
        for a in reversed(_cut_axes(entry, axes)):
            if a in mesh.shape and mesh.axis(a).ranks > 1:
                x = gather_dim(x, mesh.axis(a), d)
    return x


def rank_axes(mesh, axes) -> list:
    """The axes of ``axes`` present in ``mesh`` that span ranks."""
    return [mesh.axis(a) for a in axes
            if a in mesh.shape and mesh.axis(a).ranks > 1]


def psum_axes(x: torch.Tensor, mesh, axes=FSDP_AXES) -> torch.Tensor:
    """``x`` summed over the ranks of each of ``axes`` that spans ranks,
    each sum gathered and then added in rank order
    (``core/mesh.py::psum``), so every rank holds the same bits."""
    from repro_torch.core.mesh import psum
    for ax in rank_axes(mesh, axes):
        x = psum(x.unsqueeze(0), 0, ax)
    return x


def reduce_leaf(grad: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A leaf's gradient summed over the data ranks and cut to this
    rank's block of the data axes (its model dims, if any, are already
    this rank's block): over ``pod`` then ``data``, as
    :func:`psum_axes` sums, each a reduce-scatter in rank order
    (``core/mesh.py::reduce_scatter``) where the spec cuts a dim over
    the axis, else a reduce-scatter and an all-gather
    (``core/mesh.py::all_reduce``).  The same bits as :func:`psum_axes`
    then the cut, at 1 / n of its traffic for a cut leaf."""
    from repro_torch.core.mesh import all_reduce, reduce_scatter
    dims = {a: d for d, entry in enumerate(spec) for a in _names(entry)}
    x = grad
    for ax in rank_axes(mesh, FSDP_AXES):
        if ax.name in dims:
            x = reduce_scatter(x, ax, dims[ax.name])
        else:
            x = all_reduce(x, ax)
    return x


def counted_here(spec, mesh) -> bool:
    """Whether this rank counts a leaf of ``spec`` in a sum over ranks:
    a leaf replicated over an axis that spans ranks is counted by the
    ranks at coordinate 0 of that axis only, so every element is counted
    once over the group."""
    named = {a for entry in spec for a in _names(entry)}
    return all(mesh.axis(n).index == 0 for n in mesh.axis_names
               if mesh.axis(n).ranks > 1 and n not in named)

