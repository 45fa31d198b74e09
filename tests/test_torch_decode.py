"""The port's LM serving step against the reference package.

Mirrors tests/test_fd_distributed.py::test_serve_step_fd_equals_cn and
the reference's ``serve decode`` loop, on qwen2-0.5b's smoke config
(f32) with the reference's weights (``M.init_params(PRNGKey(0), ...)``)
carried across by ``params_from_reference``.  The reference runs on 4
forced CPU devices (``make_host_mesh(model=4)``: a model axis of 4);
every JAX output comes from ONE subprocess (an ``.npz``), and the port's
CPU path, with 4 virtual peers on one device, is compared with it
in-process:

- fed the reference's logits, the serve step's top-k (FD under every
  schedule, CN, CN*, k = 8 and 20; and ``lax.top_k`` at one peer) is
  bit-equal to the reference's ``fd_topk`` / ``lax.top_k``;
- given the reference's Gumbel noise, the sampled token equals the
  reference serve step's (the subprocess first asserts the noise rule
  ``categorical == argmax(log(p + 1e-9) + gumbel)`` on the installed
  JAX);
- 8 steps of prefill + decode give the reference's token ids exactly;
- ``state_from_prefill`` gives the reference's padded caches (rtol
  1e-4, atol 1e-5; zeros past the prompt exactly);
- fd, cn and cn_star sample the same tokens;
- both packages emit token ids >= ``vocab_size``: the logits cover the
  padded vocabulary and its padding rows are random (ROADMAP Queue 3);
- the tensors the serve step hands the top-k and merge entry points are
  contiguous, f32 / int32, also from a bf16 model.
"""
import dataclasses

import numpy as np
import pytest
import torch
from conftest import run_with_devices

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core import fd as fd_mod
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import state_from_prefill
from repro_torch.models import model as M
from repro_torch.runtime import steps
from repro_torch.runtime.steps import (make_prefill_step, make_serve_step,
                                       sample_topk)

CFG = smoke_config(get_config("qwen2-0.5b"))
B, S, GEN, STEPS = 4, 8, 12, 8
SCHEDULES = ("halving", "doubling", "ring")
KS = (8, 20)

_REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import get_config, smoke_config
from repro.core import fd
from repro.jaxcompat import use_mesh
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import state_from_prefill
from repro.models import model as M
from repro.runtime.steps import make_serve_step
inp = dict(np.load({inp!r}))
out = {{}}

def flat(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(f"{{prefix}}/{{k}}", v)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(f"{{prefix}}/{{i}}", v)
    else:
        out[prefix] = np.asarray(tree)

cfg = smoke_config(get_config("qwen2-0.5b"))
mesh = make_host_mesh(model=4)
assert dict(mesh.shape) == {{"data": 1, "model": 4}}, mesh.shape
ctx = use_mesh(mesh)
ctx.__enter__()
params = jax.jit(M.init_params, static_argnums=1,
                 static_argnames="max_seq")(jax.random.PRNGKey(0), cfg,
                                            max_seq=64)
flat("params", params)
toks = jnp.asarray(inp["tokens"])
last, pst = jax.jit(lambda p, t: M.prefill(p, cfg, {{"tokens": t}}))(
    params, toks)
state = state_from_prefill(cfg, pst, {s} + {gen})
flat("padded", state.caches)
tok0 = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
logits, _ = jax.jit(lambda p, s, t: M.decode_step(p, cfg, s, t))(
    params, state, tok0)
scores = logits[:, 0].astype(jnp.float32)
out["scores"] = scores
topk = jax.jit(fd.fd_topk, static_argnums=(1, 2, 3),
               static_argnames=("schedule", "algorithm", "batch_axes"))
for k in {ks!r}:
    for sch in {schedules!r}:
        out[f"fd/{{k}}/{{sch}}/v"], out[f"fd/{{k}}/{{sch}}/i"] = topk(
            scores, k, mesh, "model", schedule=sch, batch_axes=("data",))
    for alg in ("cn", "cn_star"):
        out[f"{{alg}}/{{k}}/v"], out[f"{{alg}}/{{k}}/i"] = topk(
            scores, k, mesh, "model", algorithm=alg, batch_axes=("data",))
    out[f"top_k/{{k}}/v"], out[f"top_k/{{k}}/i"] = jax.lax.top_k(scores, k)
# the noise rule the port relies on: categorical == argmax(logp + gumbel)
for seed in range(8):
    key = jax.random.PRNGKey(seed)
    v = out["fd/8/halving/v"]
    logp = jnp.log(jax.nn.softmax(v, axis=-1) + 1e-9)
    g = jax.random.gumbel(key, logp.shape)
    assert (jnp.argmax(logp + g, axis=-1)
            == jax.random.categorical(key, logp, axis=-1)).all()
step = jax.jit(make_serve_step(cfg, mesh, k=8))
key = jax.random.PRNGKey(3)
out["one/noise"] = jax.random.gumbel(key, (tok0.shape[0], 8))
out["one/tok"], _ = step(params, state, tok0, key)
# the decode loop of serve decode: argmax of the prefill, then steps
key = jax.random.PRNGKey(1)
tok, toks_out = tok0, [tok0]
for i in range({steps}):
    key, sub = jax.random.split(key)
    out[f"loop/noise/{{i}}"] = jax.random.gumbel(sub, (tok.shape[0], 8))
    tok, state = step(params, state, tok, sub)
    toks_out.append(tok)
out["loop/tokens"] = jnp.concatenate(toks_out, axis=1)
np.savez({out_path!r}, **out)
print("REFERENCE_OK")
"""


def _tree(flat, prefix):
    """The nested dicts / lists under ``prefix`` of a flattened tree."""
    tree = {}
    for key, a in flat.items():
        if key.startswith(prefix + "/"):
            node = tree
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
    return listify(tree)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(inputs, reference outputs), all from one 4-device subprocess."""
    d = tmp_path_factory.mktemp("decode_ref")
    rng = np.random.default_rng(5)
    inp = {"tokens": rng.integers(0, CFG.vocab_size, (B, S)).astype(
        np.int32)}
    np.savez(d / "inp.npz", **inp)
    out = run_with_devices(_REFERENCE.format(
        inp=str(d / "inp.npz"), out_path=str(d / "out.npz"), s=S, gen=GEN,
        ks=KS, schedules=SCHEDULES, steps=STEPS), n_devices=4, timeout=600)
    assert "REFERENCE_OK" in out
    return inp, dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def params(ref):
    tree = _tree(ref[1], "params")
    tree["dec"].setdefault("rem", [])      # an empty list saves no key
    return M.params_from_reference(tree, CFG, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mesh(p):
    return make_host_mesh(model=p, device="cpu", cfg=CFG)


def _prefilled(params, inp):
    """(the port's decode state, padded to S + GEN, and the argmax of the
    prefill's last logits)."""
    last, st = make_prefill_step(CFG)(params, {"tokens": _t(inp["tokens"])})
    tok0 = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    return state_from_prefill(CFG, st, S + GEN), tok0


def _same(got, want):
    np.testing.assert_array_equal(got.numpy().view(np.uint32)
                                  if got.dtype == torch.float32
                                  else got.numpy(),
                                  want.view(np.uint32)
                                  if want.dtype == np.float32 else want)


_CASES = [(k, "fd", sch) for k in KS for sch in SCHEDULES] + \
    [(k, alg, "halving") for k in KS for alg in ("cn", "cn_star")]


@pytest.mark.parametrize("k,algorithm,schedule", _CASES)
def test_topk_of_reference_logits_is_bit_equal(ref, k, algorithm,
                                               schedule):
    _, out = ref
    step = make_serve_step(CFG, _mesh(4), k=k, algorithm=algorithm,
                           schedule=schedule)
    vals, idx = step.select(_t(out["scores"]))
    key = f"fd/{k}/{schedule}" if algorithm == "fd" else f"{algorithm}/{k}"
    _same(vals, out[f"{key}/v"])
    _same(idx, out[f"{key}/i"])


@pytest.mark.parametrize("k", KS)
def test_one_peer_takes_lax_top_k_order(ref, k):
    _, out = ref
    vals, idx = make_serve_step(CFG, _mesh(1), k=k).select(_t(out["scores"]))
    _same(vals, out[f"top_k/{k}/v"])
    _same(idx, out[f"top_k/{k}/i"])


def test_sampled_token_equals_reference_given_its_noise(ref, params):
    inp, out = ref
    state, tok0 = _prefilled(params, inp)
    step = make_serve_step(CFG, _mesh(4), k=8)
    vals, idx = step.select(_t(out["scores"]))
    _same(sample_topk(vals, idx, _t(out["one/noise"])), out["one/tok"])
    tok, st = step(params, state, tok0, None, noise=_t(out["one/noise"]))
    _same(tok, out["one/tok"])
    assert st.pos == S + 1


def test_decode_loop_gives_reference_tokens(ref, params):
    """Prefill, argmax, then 8 serve steps (FD halving over 4 peers,
    k = 8), each given the reference's noise: the same token ids."""
    inp, out = ref
    state, tok = _prefilled(params, inp)
    step = make_serve_step(CFG, _mesh(4), k=8)
    toks = [tok]
    for i in range(STEPS):
        tok, state = step(params, state, tok, None,
                          noise=_t(out[f"loop/noise/{i}"]))
        toks.append(tok)
    got = torch.cat(toks, dim=1)
    _same(got, out["loop/tokens"])
    # the padded vocabulary: both packages emit ids past vocab_size
    assert (out["loop/tokens"] >= CFG.vocab_size).any()
    assert int(got.max()) < CFG.padded_vocab()


def test_state_from_prefill_matches_reference(ref, params):
    inp, out = ref
    state, _ = _prefilled(params, inp)
    want = _tree(out, "padded")["groups"][0]["self"]
    assert state.pos == S
    for i, c in enumerate(state.caches):
        for got, w in ((c["self"].k, want[0][i]), (c["self"].v, want[1][i])):
            assert got.dtype == torch.float32
            assert got.shape == (B, S + GEN, CFG.n_kv_heads,
                                 CFG.resolved_head_dim)
            assert not got[:, S:].any() and not w[:, S:].any()
            torch.testing.assert_close(got, _t(w), rtol=1e-4, atol=1e-5)


def test_fd_cn_and_cn_star_sample_the_same_tokens(ref, params):
    """The port's serve steps under fd, cn and cn_star, each from a fresh
    prefilled state and the same generator seed: the same tokens."""
    inp, _ = ref
    outs = {}
    for alg in ("fd", "cn", "cn_star"):
        state, tok = _prefilled(params, inp)
        step = make_serve_step(CFG, _mesh(4), k=8, algorithm=alg)
        gen = torch.Generator().manual_seed(7)
        toks = []
        for _ in range(4):
            tok, state = step(params, state, tok, gen)
            toks.append(tok)
        outs[alg] = torch.cat(toks, dim=1)
    torch.testing.assert_close(outs["fd"], outs["cn"], rtol=0, atol=0)
    torch.testing.assert_close(outs["fd"], outs["cn_star"], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_get_contiguous_f32_and_int32(monkeypatch, dtype):
    """What the decode hands the top-k and merge entry points: contiguous
    f32 scores (the reference's cast, also from bf16 logits) and lists,
    int32 owners; the halving rounds' masked lists (-inf / -1) too.
    On the card these go to ``topk_cuda`` / ``merge_cuda``, which refuse
    anything else."""
    cfg = dataclasses.replace(CFG, param_dtype=dtype, compute_dtype=dtype)
    seen = []

    def spy(name, fn):
        def call(*args, **kw):
            seen.append((name, args))
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(fd_mod, "local_topk",
                        spy("topk", fd_mod.local_topk))
    monkeypatch.setattr(fd_mod, "merge_scorelists",
                        spy("merge", fd_mod.merge_scorelists))
    monkeypatch.setattr(steps, "local_topk", spy("topk", steps.local_topk))
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    state = M.init_decode_state(cfg, batch=2, s_max=4,
                                cache_dtype=torch.float32, device="cpu")
    tok = torch.ones((2, 1), dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    for p, alg, sch in ((4, "fd", "halving"), (4, "fd", "doubling"),
                        (4, "fd", "ring"), (4, "cn", "halving"),
                        (4, "cn_star", "halving"), (1, "fd", "halving")):
        step = make_serve_step(cfg, make_host_mesh(p, cfg=cfg, device="cpu"),
                               k=8, algorithm=alg, schedule=sch)
        step(params, state, tok, gen)
    names = {name for name, _ in seen}
    assert names == {"topk", "merge"}
    masked = 0
    for name, args in seen:
        if name == "topk":
            assert args[0].dtype == torch.float32
            assert args[0].is_contiguous()
        else:
            va, ia, vb, ib = args
            for v, i in ((va, ia), (vb, ib)):
                assert v.dtype == torch.float32 and i.dtype == torch.int32
                assert v.is_contiguous() and i.is_contiguous()
            masked += int(torch.isneginf(vb).all(-1).sum())
            assert torch.equal(torch.isneginf(vb).all(-1),
                               (ib == -1).all(-1))
    assert masked > 0                   # halving's non-receivers


def test_make_host_mesh_refuses_a_ragged_vocab_shard():
    assert make_host_mesh(16, device="cpu", cfg=CFG).shape == \
        {"data": 1, "model": 16}
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(3, device="cpu", cfg=CFG)
