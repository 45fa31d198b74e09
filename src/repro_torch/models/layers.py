"""Basic layers of the port: init helpers, norms and dense FFNs.

Parameters are ``nn.ParameterDict``s keyed as the reference's pytree
leaves (``{"scale", "bias"}``, ``{"w_gate", "w_up", "w_down"}``, ...),
and the apply functions compute what the reference's do, in the same
order and the same dtypes.

The mesh helpers read the mesh that :func:`use_mesh` makes current, as
the reference's read the ambient JAX mesh: ``batch_spec``,
``model_size``, ``head_axis``, ``_mesh_axis_names``,
``local_batch_shards`` (the data peers this process holds, which MoE
dispatches over), ``model_ranks`` (the model axis where it spans ranks),
``split_axis`` (whether a leaf is a block on its model rank) and
``seq_block`` (this rank's block of an attention cache's sequence).

Over model ranks, a leaf that the partition rules put over ``model``
(``optim/sharding.py``) is this rank's block, and the products run on
the blocks: a column block's input passes ``copy_to_model`` and a row
block's output ``reduce_from_model`` (``core/mesh.py``), so the ranks
exchange only activations.  Over one rank every collective is the
identity and the arithmetic is the one-process path's.  The reference's
``constrain`` only annotates activations' layout for GSPMD and changes
no value; it has no counterpart.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.mesh import copy_to_model, reduce_from_model

# mesh axis-name conventions used everywhere
BATCH_AXES = ("pod", "data")   # "pod" present only in the multi-pod mesh
MODEL_AXIS = "model"

# the current mesh: a module global, not a context variable, so that a
# step run on the watchdog's thread sees the mesh its caller set
_CURRENT = [None]


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``core/mesh.py::Mesh``, or None) current inside
    the block (``jaxcompat.use_mesh``)."""
    prev = _CURRENT[0]
    _CURRENT[0] = mesh
    try:
        yield mesh
    finally:
        _CURRENT[0] = prev


def _mesh_axis_names() -> tuple:
    mesh = _CURRENT[0]
    return tuple(mesh.axis_names) if mesh is not None else ()


def batch_spec():
    """The (possibly multi-pod) batch sharding axes present in the mesh."""
    kept = tuple(a for a in BATCH_AXES if a in _mesh_axis_names())
    return kept if kept else None


def model_size() -> int:
    """Size of the model axis in the current mesh, else 1."""
    mesh = _CURRENT[0]
    return mesh.shape.get(MODEL_AXIS, 1) if mesh is not None else 1


def head_axis(n_heads: int):
    """``model`` iff the head count divides the model axis evenly."""
    ms = model_size()
    return MODEL_AXIS if ms > 1 and n_heads % ms == 0 else None


def model_ranks():
    """The current mesh's ``model`` axis (a ``core/mesh.py::Axis``) where
    it spans ranks, else None."""
    mesh = _CURRENT[0]
    if mesh is None or MODEL_AXIS not in mesh.shape:
        return None
    ax = mesh.axis(MODEL_AXIS)
    return ax if ax.ranks > 1 else None


def split_axis(kind: str, name: str, cfg, dim_size: int):
    """The model axis where leaf ``name`` of a ``kind`` block
    (``optim/sharding.py``'s kinds) is a block on each model rank: the
    axis spans ranks and the rule table puts ``model`` on the leaf for
    the mesh's model size, its cut dim of ``dim_size`` entries (taken
    from the config) fitting; else None."""
    ax = model_ranks()
    if ax is None:
        return None
    from repro_torch.optim.sharding import splits_over_model
    return ax if splits_over_model(kind, name, cfg, ax.size,
                                   dim_size) else None


def seq_block(dim: int):
    """(the model axis, start, length) of this rank's block of an
    attention cache's sequence dim of ``dim`` entries under the current
    mesh (``optim/sharding.py::cache_seq_block``), or None where the
    rank holds the dim whole."""
    from repro_torch.optim.sharding import cache_seq_block
    block = cache_seq_block(dim, _CURRENT[0])
    return None if block is None else (model_ranks(),) + block


def local_batch_shards() -> int:
    """How many data shards of the batch this process holds: the
    product of its local peers on each batch axis of the current mesh
    (all of an axis's peers on one process, one a rank where each rank
    holds one), 1 without a mesh."""
    mesh = _CURRENT[0]
    if mesh is None:
        return 1
    return math.prod(mesh.axis(a).local for a in BATCH_AXES
                     if a in mesh.shape)


def param_dict(tensors: dict) -> nn.ParameterDict:
    """``tensors`` as trainable parameters (the serving functions run
    under ``torch.no_grad``, so they build no graph).  A nested dict
    (MLA's ``q_norm``) becomes a nested ``ParameterDict``, so
    ``params["q_norm"]["scale"]`` reads as the reference's pytree
    does."""
    return nn.ParameterDict({
        k: param_dict(v) if isinstance(v, dict) else nn.Parameter(v)
        for k, v in tensors.items()})


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, the reference's dtype for norms, carries and
    recurrences; an f64 tensor stays f64, so that a model cast to f64
    (an error analysis) computes in f64 throughout."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    """A (d_in, d_out) weight, N(0, 1) * ``scale`` drawn in f32 on the
    generator's device, then cast; applied as ``x @ w``."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    """A (vocab, d) table, N(0, 1) * 0.02: every row, the padding rows
    past ``vocab_size`` too, as in the reference."""
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def norm_init(d: int, kind: str, dtype, device) -> dict:
    if kind == "rms":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (``"rms"``) or LayerNorm (``"ln"``), computed in f32
    (:func:`wide`) and returned in ``x``'s dtype."""
    xf = wide(x)
    if kind == "rms":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * params["scale"].to(xf.dtype)).to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(xf.dtype) + params["bias"].to(xf.dtype)
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# dense FFN (SwiGLU / GELU)
# --------------------------------------------------------------------------

def ffn_init(gen: torch.Generator, d: int, d_ff: int, act: str,
             dtype) -> dict:
    dev = gen.device
    if act == "swiglu":
        return {"w_gate": dense_init(gen, d, d_ff, dtype),
                "w_up": dense_init(gen, d, d_ff, dtype),
                "w_down": dense_init(gen, d_ff, d, dtype,
                                     scale=d_ff ** -0.5)}
    return {"w_up": dense_init(gen, d, d_ff, dtype),
            "b_up": torch.zeros((d_ff,), dtype=dtype, device=dev),
            "w_down": dense_init(gen, d_ff, d, dtype, scale=d_ff ** -0.5),
            "b_down": torch.zeros((d,), dtype=dtype, device=dev)}


def apply_ffn(params, x: torch.Tensor, act: str, cfg=None,
              width: int = 0) -> torch.Tensor:
    """SwiGLU, or GELU with the tanh approximation (``jax.nn.gelu``'s
    default).

    Given ``cfg`` (and the hidden ``width``, ``cfg.d_ff`` by default),
    over model ranks where the rules split the hidden dim: ``w_gate`` /
    ``w_up`` / ``b_up`` are column blocks and ``w_down`` a row block,
    the input passes ``copy_to_model``, the output ``reduce_from_model``,
    and ``b_down`` is added once, after the sum."""
    ax = None if cfg is None else split_axis("ffn", "w_up", cfg,
                                             width or cfg.d_ff)
    x = copy_to_model(x, ax)
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
        return reduce_from_model(h @ params["w_down"], ax)
    h = F.gelu(x @ params["w_up"] + params["b_up"], approximate="tanh")
    return reduce_from_model(h @ params["w_down"], ax) + params["b_down"]


# --------------------------------------------------------------------------
# RWKV channel mix (the rwkv_channel_mix "ffn")
# --------------------------------------------------------------------------

def rwkv_cmix_init(gen: torch.Generator, d: int, d_ff: int, dtype) -> dict:
    dev = gen.device
    return {"w_k": dense_init(gen, d, d_ff, dtype),
            "w_v": dense_init(gen, d_ff, d, dtype, scale=d_ff ** -0.5),
            "w_r": dense_init(gen, d, d, dtype),
            "mix_k": torch.full((d,), 0.5, dtype=dtype, device=dev),
            "mix_r": torch.full((d,), 0.5, dtype=dtype, device=dev)}


def apply_rwkv_cmix(params, x: torch.Tensor, x_prev: torch.Tensor,
                    cfg=None):
    """RWKV channel mix with token shift.  x: (B, S, D); x_prev: (B, 1,
    D), the f32 carry.  Returns (y, x's last token in f32), so that the
    decode cache's dtype stays f32.  Given ``cfg``, over model ranks
    where the rules split ``d_ff``: ``w_k`` is a column block and
    ``w_v`` a row block, ``k @ w_v`` summed over the ranks; ``w_r`` and
    the mixes stay whole, and ``r * v`` is taken after the sum."""
    ax = None if cfg is None else split_axis("ffn", "w_k", cfg, cfg.d_ff)
    shifted = torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)
    xk = x * params["mix_k"] + shifted * (1 - params["mix_k"])
    xr = x * params["mix_r"] + shifted * (1 - params["mix_r"])
    k = torch.square(torch.relu(copy_to_model(xk, ax) @ params["w_k"]))
    v = reduce_from_model(k @ params["w_v"], ax)
    r = torch.sigmoid(xr @ params["w_r"])
    return r * v, wide(x[:, -1:])
