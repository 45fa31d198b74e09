"""Shared pieces of the LM tests that hold the port to the reference
package (tests/test_torch_moe.py, tests/test_torch_recurrent.py).

``REFERENCE_HEAD`` opens the one JAX subprocess of a test file: it
loads the inputs, defines ``flat`` (a pytree into ``out`` under
"/"-joined keys) and ``model_run`` (one arch's weights, ``forward``,
``prefill`` and its caches, ``state_from_prefill`` and teacher-forced
``decode_step``s, each prompt of ``prompts`` on the same weights).  The
port side reads the ``.npz`` back with :func:`tree` and compares with
:func:`close`, :func:`close_all` and :func:`close_caches`.
"""
import numpy as np
import torch

TOL = dict(rtol=1e-4, atol=1e-5)
MAX_SEQ = 64

REFERENCE_HEAD = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import get_config, smoke_config
from repro.launch.serve import state_from_prefill
from repro.models import model as M
inp = dict(np.load({inp!r}))
out = {{}}

def flat(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(f"{{prefix}}/{{k}}", v)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(f"{{prefix}}/{{i}}", v)
    elif tree is not None:
        out[prefix] = np.asarray(tree)

def model_run(tag, cfg, prompts, gen):
    params = jax.jit(M.init_params, static_argnums=1,
                     static_argnames="max_seq")(jax.random.PRNGKey(0), cfg,
                                                max_seq={max_seq})
    flat(f"{{tag}}/params", params)
    out[f"{{tag}}/count"] = np.asarray(M.count_params(params))
    fwd = jax.jit(lambda p, b: M.forward(p, cfg, b, mode="train"))
    pre = jax.jit(lambda p, b: M.prefill(p, cfg, b))
    step = jax.jit(lambda p, s, t: M.decode_step(p, cfg, s, t))
    for name in prompts:
        key = f"{{tag}}/{{name}}"
        batch = {{"tokens": jnp.asarray(inp[f"{{key}}/tokens"])}}
        logits, _, aux = fwd(params, batch)
        out[f"{{key}}/forward"] = logits
        out[f"{{key}}/forward_aux"] = aux
        last, pst = pre(params, batch)
        out[f"{{key}}/prefill"] = last
        flat(f"{{key}}/prefill_caches", pst.caches)
        forced = inp[f"{{key}}/forced"]
        st = state_from_prefill(cfg, pst, batch["tokens"].shape[1] + gen)
        flat(f"{{key}}/padded_caches", st.caches)
        for i in range(gen):
            lg, st = step(params, st, jnp.asarray(forced[:, i:i + 1]))
            out[f"{{key}}/decode/{{i}}"] = lg
        flat(f"{{key}}/decode_caches", st.caches)
    return params
"""


def tree(flat, prefix):
    """The nested dicts / lists under ``prefix`` of a flattened tree."""
    out = {}
    for key, a in flat.items():
        if key.startswith(prefix + "/"):
            node = out
            *parts, last = key[len(prefix) + 1:].split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[last] = a

    def listify(t):
        if not isinstance(t, dict):
            return t
        t = {k: listify(v) for k, v in t.items()}
        if t and all(k.isdigit() for k in t):
            return [t[str(i)] for i in range(len(t))]
        return t
    return listify(out)


def t(a):
    """A numpy array (a 0-d one too) as a tensor of its own."""
    return torch.from_numpy(np.array(a))


def close(got, want):
    torch.testing.assert_close(got, t(want), **TOL)


def close_all(got, want):
    """Nested tuples of tensors against the same nesting of arrays."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            close(g, w)
        else:
            close_all(g, w)


def params_of(out, tag, cfg, M):
    """The reference's weights under ``tag`` as the port's ``LM``."""
    ref = tree(out, f"{tag}/params")
    ref["dec"].setdefault("rem", [])        # an empty list saves no key
    ref["dec"].setdefault("groups", [{} for _ in cfg.mixer_pattern])
    return M.params_from_reference(ref, cfg, device="cpu")


def close_caches(caches, want, cfg):
    """The port's per-layer cache dicts against the reference's (scan
    groups stacked over the group axis, then the remainder layers):
    port layer ``g * P + slot`` is group g of slot ``slot``."""
    p = len(cfg.mixer_pattern)
    n_groups = cfg.n_layers // p
    assert len(caches) == cfg.n_layers
    for i, layer in enumerate(caches):
        if i < n_groups * p:
            w, g = want["groups"][i % p], i // p

            def pick(a, g=g):
                return a[g]
        else:
            w = want["rem"][i - n_groups * p]

            def pick(a):
                return a
        assert set(layer) == set(w), (i, sorted(layer), sorted(w))
        for key, c in layer.items():
            if isinstance(c, torch.Tensor):
                close(c, pick(w[key]))
            else:
                assert len(c) == len(w[key])
                for j, a in enumerate(c):
                    close(a, pick(w[key][j]))


def ref_leaf(name, cfg):
    """Where the port's parameter ``name`` (``LM.named_parameters()``)
    lies in the reference's flattened tree: (key, index), the index of a
    layer stacked over its scan group, or None.  Decoder layer ``i`` of
    ``n_groups * P`` grouped layers (``P = len(cfg.mixer_pattern)``) is
    group ``i // P`` of slot ``i % P``, the rest ``rem``; every encoder
    layer is stacked (pattern ``("attn",)``)."""
    parts = name.split(".")
    p = len(cfg.mixer_pattern)
    grouped = cfg.n_layers // p * p
    if parts[0] == "layers":
        i, rest = int(parts[1]), "/".join(parts[2:])
        if i < grouped:
            return f"dec/groups/{i % p}/{rest}", i // p
        return f"dec/rem/{i - grouped}/{rest}", None
    if parts[:2] == ["enc", "layers"]:
        return f"enc/stack/groups/0/{'/'.join(parts[3:])}", int(parts[2])
    return "/".join(parts), None


def ref_value(out, prefix, name, cfg):
    """The reference's array for the port's parameter ``name`` under
    ``prefix`` of a flattened tree (a parameter or its gradient)."""
    key, i = ref_leaf(name, cfg)
    a = out[f"{prefix}/{key}"]
    return a if i is None else a[i]
