"""The products split over model ranks, against the reference package
and the one-process port.

Over gloo ranks (``launch.ranks.spawn_ranks``, each group under a time
limit; ``tests/torch_model_ranks_worker.py``) every leaf the partition
rules put over ``model`` stays this rank's block through the train step
and the decode step, the products run on the blocks, and the model
ranks exchange only activations (``core/mesh.py``'s ``copy_to_model``,
``reduce_from_model``, ``gather_from_model``, ``slice_to_model``).
The reference's outputs come from ONE JAX subprocess with 4 forced CPU
devices, started first and run while the ranks do: its train step (2
microbatches, 2 steps) of granite-moe-1b-a400m's and qwen2-0.5b's smoke
configs on a (2, 2) host mesh from the port's initial weights, and
both archs' decode on that mesh with each step's Gumbel noise (two
train-step compiles, two serve-step compiles).

Tolerances:

* the step-1 collectives: bit for bit (every rank the same bits, the
  sum in rank order), bytes exactly 2 (n - 1) / n of the operand;
* ``reduce_leaf``: bit for bit against ``psum_axes`` then the cut;
* each module at smoke size in f64 over model ranks against the
  one-process port: rtol 1e-12, atol 1e-12 of the largest magnitude of
  the case's outputs and gradients (a gradient that is zero in exact
  arithmetic is rounding noise on both sides);
* train steps: loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-5, the
  gradient's norm rtol 1e-4 (``tests/test_torch_train_ranks.py``'s),
  against the reference at (2, 2) and the one-process port at (1, 4)
  and, in f64, for the other families at (1, 2); the replicated leaves
  bit-equal on every model rank;
* the decode: the reference's tokens given its noise; each model rank's
  logits block the one-process logits' columns within rtol 1e-5, atol
  1e-5 of the block's largest magnitude (f32: about 2e-6 apart);
* checkpoints: bit for bit across layouts;
* ``adamw.global_norm`` over ranks: the one-process norm of the whole
  tree within rtol 1e-6 (f32 sums in another order).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO
from repro_torch.ckpt.checkpoint import restore
from repro_torch.core.mesh import Mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.launch.serve import state_from_prefill
from repro_torch.models import model as M
from repro_torch.optim import sharding as S
from repro_torch.optim.adamw import AdamWConfig, adamw_init, global_norm

import torch_model_ranks_worker as W
import torch_train_ranks_worker as TW
from torch_lm_ref import ref_leaf

ARCHS = ("granite-moe-1b-a400m", "qwen2-0.5b")
FAMILIES = ("minicpm3-4b", "whisper-large-v3", "rwkv6-3b",
            "recurrentgemma-2b", "qwen2-vl-72b", "moonshot-v1-16b-a3b")
LAYOUTS = ((2, 2), (1, 4))
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
NORM_TOL = dict(rtol=1e-4, atol=0.0)
MODULE_RTOL = 1e-12
LOGITS_RTOL = 1e-5
TIMEOUT = 240

_REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro import jaxcompat
from repro.configs.base import get_config, smoke_config
from repro.data.pipeline import SyntheticLM, device_put_batch
from repro.launch.serve import state_from_prefill
from repro.models import model as M
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.optim.sharding import batch_axes, param_specs
from repro.runtime.steps import make_serve_step, make_train_step
inp = dict(np.load({inp!r}))
out = {{}}

def key_of(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

def weights(arch, cfg):
    like = jax.eval_shape(lambda k: M.init_params(k, cfg, max_seq={max_seq}),
                          jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(inp[arch + "/params/" + key_of(p)]), like)

mesh = jaxcompat.make_mesh((2, 2), ("data", "model"),
                           devices=jax.devices()[:4])
ocfg = AdamWConfig(**{opt!r})
for arch in {archs!r}:
    cfg = smoke_config(get_config(arch))
    params0 = weights(arch, cfg)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len={seq},
                       global_batch={b})
    with jaxcompat.use_mesh(mesh):
        shard = jax.tree.map(lambda s: NamedSharding(mesh, s),
                             param_specs(params0, cfg, mesh))
        p = jax.device_put(params0, shard)
        st = adamw_init(p, ocfg)
        step = jax.jit(make_train_step(
            cfg, ocfg, microbatches={micro}, remat="none",
            batch_axes=batch_axes(dict(mesh.shape))))
        for i in range({steps}):
            p, st, om = step(p, st, device_put_batch(data.batch_at(i), mesh))
            out[f"{{arch}}/loss/{{i}}"] = np.asarray(om["loss"])
            out[f"{{arch}}/grad_norm/{{i}}"] = np.asarray(om["grad_norm"])
        for path, a in jax.tree_util.tree_flatten_with_path(p)[0]:
            out[f"{{arch}}/params/{{key_of(path)}}"] = np.asarray(a)
        # the decode, as serve decode --model-par 2 runs it on 4 devices
        batch = {{"tokens": jnp.asarray(inp["decode/tokens"])}}
        last, pst = M.prefill(params0, cfg, batch)
        state = state_from_prefill(cfg, pst, {dec_prompt} + {dec_gen})
        serve_step = jax.jit(make_serve_step(cfg, mesh, k={dec_k},
                                             batch_axes=("data",)))
        tok = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
        toks, noise = [tok], []
        key = jax.random.PRNGKey(1)
        for i in range({dec_gen} - 1):
            key, sub = jax.random.split(key)
            noise.append(jax.random.gumbel(sub, ({dec_b}, {dec_k}),
                                           jnp.float32))
            tok, state = serve_step(params0, state, tok, sub)
            toks.append(tok)
    out[f"{{arch}}/decode/noise"] = np.stack([np.asarray(n) for n in noise])
    out[f"{{arch}}/decode/out"] = np.concatenate([np.asarray(t) for t in toks],
                                               axis=1)
np.savez({out_path!r}, **out)
print("REFERENCE_OK")
"""


def _reference_tree(arch):
    """The port's initial weights in the reference's tree, by key."""
    cfg, params = TW.init(arch)
    groups = {}
    for name, p in params.named_parameters():
        key, g = ref_leaf(name, cfg)
        groups.setdefault(key, {})[g] = p.detach().numpy()
    return {f"{arch}/params/{key}": (v[None] if None in v else np.stack(
        [v[g] for g in range(len(v))])) for key, v in groups.items()}


@pytest.fixture(scope="module")
def pending_ref(tmp_path_factory):
    """The reference's subprocess, started first."""
    d = tmp_path_factory.mktemp("model_ranks_ref")
    inp = {}
    for arch in ARCHS:
        inp.update(_reference_tree(arch))
    inp["decode/tokens"] = np.random.default_rng(29).integers(
        0, 512, (TW.DEC_B, TW.DEC_PROMPT)).astype(np.int32)
    np.savez(d / "inp.npz", **inp)
    code = _REFERENCE.format(
        inp=str(d / "inp.npz"), out_path=str(d / "out.npz"),
        max_seq=TW.MAX_SEQ, opt=TW.OPT, archs=ARCHS, seq=TW.SEQ, b=TW.B,
        micro=TW.MICRO, steps=TW.STEPS, dec_prompt=TW.DEC_PROMPT,
        dec_gen=TW.DEC_GEN, dec_k=TW.DEC_K, dec_b=TW.DEC_B)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, d / "out.npz", inp
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(pending_ref, tmp_path_factory):
    """Two groups while the reference runs: 4 ranks (the collectives,
    ``reduce_leaf``, the norm, the modules at m = 4, the train steps of
    both archs at (2, 2) and (1, 4), the (1, 4) checkpoint, then its
    restore at (2, 2)) and 2 ranks (the modules at m = 2, one step of
    each other family at (1, 2))."""
    ckpt = str(tmp_path_factory.mktemp("ckpt_1x4"))
    cases = {m: tuple(c for c in W.MODULES if c[2] == m) for m in (2, 4)}
    four = spawn_ranks(W.many, 4, args=({
        "collectives": ("collectives", {"ms": (2, 4)}),
        "reduce": ("reduce_leaves", {}),
        "norms": ("norms", {"arch": ARCHS[0]}),
        "modules": ("modules", {"cases": cases[4]}),
        "train": ("train", {"archs": ARCHS, "layouts": LAYOUTS,
                            "ckpt": (ckpt, ARCHS[0], (1, 4))}),
        "restored": ("restore_onto", {"arch": ARCHS[0], "layout": (2, 2),
                                      "dir": ckpt}),
        "remat": ("remat_steps", {"archs": ARCHS})},), timeout=TIMEOUT)
    two = spawn_ranks(W.many, 2, args=({
        "modules": ("modules", {"cases": cases[2]}),
        "families": ("family_step", {"archs": FAMILIES})},),
        timeout=TIMEOUT)
    return {4: four, 2: two, "ckpt": ckpt}


@pytest.fixture(scope="module")
def ref(pending_ref, ranks):
    proc, path, inp = pending_ref
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "REFERENCE_OK" in out, out + err
    return inp, dict(np.load(path))


@pytest.fixture(scope="module")
def decoded(ref):
    """Both archs decoded over (2, 2) ranks with the reference's noise."""
    inp, out = ref
    return spawn_ranks(W.decode, 4, args=(dict(
        archs=ARCHS, tokens=inp["decode/tokens"],
        noise={a: out[f"{a}/decode/noise"] for a in ARCHS}),),
        timeout=TIMEOUT)


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def _close(got, want, tol, what):
    torch.testing.assert_close(torch.from_numpy(np.asarray(got)),
                               torch.from_numpy(np.asarray(want)), **tol,
                               msg=what)


#: a key bias's gradient is zero in exact arithmetic (the softmax
#: cancels q . b_k); AdamW moves it by about lr whatever the noise's
#: size, so it is held to the bound of two such moves apart
#: (``tests/test_torch_train_ranks.py``)
ZERO_GRAD = (".mixer.b_k", ".cross.b_k")


def _close_params(got, want_of, what):
    bad = []
    for name, p in got.items():
        want = want_of(name)
        if name.endswith(ZERO_GRAD):
            assert np.abs(p - want).max() <= 2 * TW.STEPS * 2 * \
                TW.OPT["lr"], (what, name)
            continue
        if not np.allclose(p, want, **PARAM_TOL):
            err = np.abs(p - want) - PARAM_TOL["rtol"] * np.abs(want)
            bad.append((name, float(err.max())))
    assert not bad, (what, bad)


# --------------------------------------------------------------------------
# the step-1 collectives, reduce_leaf and the norm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
def test_model_axis_collectives(ranks, m):
    """reduce_from_model / copy_to_model / gather_from_model /
    slice_to_model over m model ranks (a (4 / m, m) mesh): the forward
    values and the conjugate gradients, every rank the same bits, each
    sum the terms stacked in rank order and summed as ``psum`` sums
    them; each sum sends 2 (m - 1) / m of its operand."""
    got = [r["collectives"][m] for r in ranks[4]]
    shape = (3, 5, 2 * m)
    xs = [W._term(r, shape) for r in range(m)]
    gs = [W._term(r, shape, 40) for r in range(m)]
    total = torch.stack(xs).sum(0, dtype=torch.float32).numpy()
    gtotal = torch.stack(gs).sum(0, dtype=torch.float32).numpy()
    common = W._term(0, shape)
    back = W._term(0, (3, 5, 2 * m * m), 70)
    operand = 3 * 5 * 2 * m * 4
    for res in got:
        r = res["coord"][1]
        assert _bits(res["reduce_y"], total)
        assert _bits(res["reduce_dx"], gs[r].numpy())
        assert _bits(res["copy_y"], xs[r].numpy())
        assert _bits(res["copy_dx"], gtotal)
        assert res["reduce_sent"] == res["copy_sent"] == \
            2 * (m - 1) * operand // m
        assert _bits(res["gather_y"], torch.cat(xs, 2).numpy())
        assert _bits(res["gather_dx"], back[..., r * 2 * m:(r + 1) * 2 * m]
                     .numpy())
        assert _bits(res["slice_y"], common[..., r * 2:(r + 1) * 2].numpy())
        assert _bits(res["slice_dx"], torch.cat(
            [W._term(j, (3, 5, 2), 90) for j in range(m)], 2).numpy())
        assert _bits(res["max"], torch.stack(
            [W._term(j, (7,)) for j in range(m)]).amax(0).numpy())


@pytest.mark.parametrize("layout", sorted(W.REDUCE_LAYOUTS))
def test_reduce_leaf_is_psum_then_cut_bit_for_bit(ranks, layout):
    """``reduce_leaf``'s reduce-scatters in rank order give the bits of
    the gather of every data rank's term, summed over ``pod`` then
    ``data`` and cut, on every leaf of two smoke models in f32 and
    bf16, at less traffic."""
    for r in ranks[4]:
        res = r["reduce"][layout]
        assert res["bad"] == []
        assert 0 < res["sent_new"] < res["sent_old"]


def test_global_norm_counts_each_block_once(ranks):
    """``adamw.global_norm`` of the ranks' blocks at (2, 2) and (1, 4):
    each model block and each leaf whole over ``model`` counted once
    (``counted_here``), the one-process norm of the whole tree; the
    same bits on every rank."""
    cfg, params = TW.init(ARCHS[0])
    whole = [W._term(0, tuple(p.shape), 500 + i)
             for i, (_, p) in enumerate(params.named_parameters())]
    want = global_norm(whole).numpy()
    for lay in LAYOUTS:
        got = [r["norms"][lay] for r in ranks[4]]
        assert all(_bits(g, got[0]) for g in got)
        _close(got[0], want, dict(rtol=1e-6, atol=0.0), f"norm {lay}")


# --------------------------------------------------------------------------
# each module in f64
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", W.MODULES, ids=[c[0] for c in W.MODULES])
def test_module_over_model_ranks_in_f64(ranks, case):
    """One module on its blocks over m model ranks, in f64: its output,
    its input's gradient and every leaf's gradient gathered to the
    global layout are the one-process port's (rtol 1e-12, atol 1e-12 of
    the case's largest magnitude).  gqa_whole_kv (4 heads, 2 KV heads
    over 4 ranks) keeps ``w_k`` / ``w_v`` / ``b_k`` / ``b_v`` whole:
    their partial gradients are summed over the ranks; gqa_uneven_kv (12
    heads, 3 KV heads over 4 ranks) reads a KV head a query head where
    a rank's query heads straddle its KV heads."""
    name, arch, m = case
    want = W.module_case(name, arch)
    scale = max(float(np.abs(v).max()) for k, v in want.items()
                if k != "n_used")
    tol = dict(rtol=MODULE_RTOL, atol=MODULE_RTOL * scale)
    outs = [r["modules"][name] for r in ranks[m]]
    assert want["n_used"] > 0
    for got in outs:
        assert set(got) == set(want)
        for key in want:
            if key != "n_used":
                _close(got[key], want[key], tol, f"{name} {key}")
        assert all(_bits(got[k], outs[0][k]) for k in want if k != "n_used")


# --------------------------------------------------------------------------
# the train steps
# --------------------------------------------------------------------------

def _train(ranks, arch, lay):
    return [r["train"][(arch, lay)] for r in ranks[4]]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_at_2x2_matches_the_reference(ref, ranks, arch):
    """Two steps over (data 2, model 2) ranks: loss, norm and the
    gathered parameters against the reference's step on its (2, 2)
    host mesh, every rank the same loss and norm bits."""
    _, out = ref
    got = _train(ranks, arch, (2, 2))
    for g in got:
        assert _bits(g["loss"], got[0]["loss"])
        assert _bits(g["grad_norm"], got[0]["grad_norm"])
    for i in range(TW.STEPS):
        _close(got[0]["loss"][i], out[f"{arch}/loss/{i}"], LOSS_TOL,
               f"loss {i}")
        _close(got[0]["grad_norm"][i], out[f"{arch}/grad_norm/{i}"],
               NORM_TOL, f"grad_norm {i}")
    cfg, _ = TW.init(arch)

    def want(name):
        key, g = ref_leaf(name, cfg)
        a = out[f"{arch}/params/{key}"]
        return a if g is None else a[g]
    _close_params(got[0]["params"], want, "reference")


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_over_model_ranks(ranks, arch, remat):
    """One step at (2, 2) under remat="full" / "dots": loss, norm and
    the gathered parameters bit for bit those of the same step without
    remat (the recompute replays the same products on the same bits);
    every rank makes the same collectives in the same order, each of
    the same size (a rank that replayed a sum its peers did not would
    hang or mix up their terms); the model-axis bytes each rank sends
    are the specs' plus ``model_axis_events``' reckoning with the
    recompute's replays, more than without remat."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import chip_train_ranks as CT
    got = [r["remat"][(arch, remat)] for r in ranks[4]]
    plain = [r["remat"][(arch, "none")] for r in ranks[4]]
    for g, p in zip(got, plain):
        assert _bits(g["loss"], p["loss"])
        assert _bits(g["grad_norm"], p["grad_norm"])
        assert set(g["params"]) == set(p["params"])
        assert all(_bits(g["params"][n], p["params"][n]) for n in g["params"])
        assert g["sent"] == got[0]["sent"]
    cfg, _ = TW.init(arch)
    rows = TW.B // 2
    for rm, res in ((remat, got[0]), ("none", plain[0])):
        acts = CT.model_axis_bytes(CT.model_axis_events(
            cfg, "train", rows, TW.SEQ, 2, 2, TW.MICRO, rm), 2)
        model = sum(n for a, n in res["sent"] if a == "model")
        assert model == res["by_axis"]["model"] + acts["sent"], rm
    assert sum(n for a, n in got[0]["sent"] if a == "model") > \
        sum(n for a, n in plain[0]["sent"] if a == "model")


@pytest.fixture(scope="module")
def one_process_1x4():
    out = {}
    for arch in ARCHS:
        cfg, params = TW.init(arch)
        state = adamw_init(params, AdamWConfig(**TW.OPT))
        params, state, res = TW.train_steps(
            arch, Mesh((1, 4), ("data", "model"), "cpu"), cfg, params, None,
            state)
        res["params"] = {n: p.detach().numpy().copy()
                         for n, p in params.named_parameters()}
        out[arch] = res
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_at_1x4_matches_one_process(ranks, one_process_1x4, arch):
    """Two steps over (data 1, model 4) ranks against the one-process
    port: loss, norm and the gathered parameters."""
    got = _train(ranks, arch, (1, 4))
    one = one_process_1x4[arch]
    for i in range(TW.STEPS):
        _close(got[0]["loss"][i], one["loss"][i], LOSS_TOL, f"loss {i}")
        _close(got[0]["grad_norm"][i], one["grad_norm"][i], NORM_TOL,
               f"grad_norm {i}")
    _close_params(got[0]["params"], lambda n: one["params"][n],
                  "one process")


@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_stay_blocks_and_replicas_stay_equal(ranks, arch, lay):
    """Through two steps every leaf keeps the shape of its block (the
    specs' cut over every rank axis, ``model`` included), every
    parameter gather of the steps names the data axes only (none over
    ``model``), a leaf the specs split over ``model`` is a real block,
    and ranks whose coordinates agree on the axes a leaf's spec names
    hold its block bit for bit: the replicated leaves across the model
    ranks too."""
    got = _train(ranks, arch, lay)
    n_params = len(got[0]["shapes_before"])
    split = 0
    for g in got:
        specs = g["specs"]
        assert g["shapes_before"] == g["shapes_after"]
        assert g["gather_axes"] == [S.FSDP_AXES]
        assert g["n_gathers"] == TW.STEPS * n_params
        cut = dict(zip(("data", "model"), lay))
        for name, shape in g["shapes_after"].items():
            whole = g["params"][name].shape
            assert shape == tuple(
                n // int(np.prod([cut.get(a, 1) for a in S._names(e)]))
                for n, e in zip(whole, specs[name] + (None,) * len(whole)))
            if "model" in {a for e in specs[name] for a in S._names(e)}:
                split += 1
                assert shape != whole, name
        for h in got:
            for name, spec in specs.items():
                named = {a for e in spec for a in S._names(e)}
                same = all(g["coord"][i] == h["coord"][i]
                           for i, a in enumerate(("data", "model"))
                           if a in named)
                if same:
                    assert _bits(g["blocks"][name], h["blocks"][name]), name
    assert split > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_step_of_each_family_at_1x2(ranks, arch):
    """One step (2 microbatches) of each other family over (data 1,
    model 2) ranks against the one-process port: MLA (minicpm3-4b, its
    attention whole on every rank), the encoder-decoder
    (whisper-large-v3, its cross attention split), RWKV-6 (the channel
    mix split, the time mix whole), the RG-LRU (recurrentgemma-2b),
    M-RoPE with the vision stub (qwen2-vl-72b) and shared experts
    (moonshot-v1-16b-a3b).  In f64 (``family_model``), within the
    train steps' tolerances."""
    cfg, params = W.family_model(arch)
    state = adamw_init(params, AdamWConfig(**TW.OPT))
    params, _, om = W.one_step(cfg, params, state,
                               Mesh((1, 2), ("data", "model"), "cpu"))
    outs = [r["families"][arch] for r in ranks[2]]
    for loss, norm, whole in outs:
        assert _bits(loss, outs[0][0]) and _bits(norm, outs[0][1])
        _close(loss, om["loss"].numpy(), LOSS_TOL, "loss")
        _close(norm, om["grad_norm"].numpy(), NORM_TOL, "grad_norm")
        _close_params(whole, lambda n: dict(params.named_parameters())[n]
                      .detach().numpy(), "one process")


# --------------------------------------------------------------------------
# the decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_at_2x2_gives_the_references_tokens(ref, decoded, arch):
    """Both archs' decode over (2, 2) ranks on the model blocks: the
    reference's tokens given its noise, on every rank; no parameter
    gathered by the serve steps and every block kept."""
    _, out = ref
    for r in decoded:
        np.testing.assert_array_equal(r[arch]["tokens"],
                                      out[f"{arch}/decode/out"])
        assert r[arch]["gathers"] == 0 and r[arch]["shapes_kept"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_blocks_are_one_process_columns(ref, decoded, arch):
    """Each model rank's vocabulary block of the prompt's last logits and
    of the first step's logits: the one-process logits' columns of that
    block, for the rank's rows (rtol 1e-5, atol 1e-5 of the block's
    largest magnitude)."""
    inp, _ = ref
    cfg, params = TW.init(arch)
    tokens = torch.from_numpy(inp["decode/tokens"])
    for r in decoded:
        res = r[arch]
        rows = torch.from_numpy(res["rows"])
        last, pst = M.prefill(params, cfg, {"tokens": tokens[rows]})
        state = state_from_prefill(cfg, pst, TW.DEC_PROMPT + TW.DEC_GEN)
        tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
        first, _ = M.decode_step(params, cfg, state, tok)
        part = cfg.padded_vocab() // 2
        cols = slice(res["coord"][1] * part, (res["coord"][1] + 1) * part)
        for got, want, what in ((res["last"], last[:, cols], "prefill"),
                                (res["first"], first[:, 0, cols], "step")):
            want = want.numpy()
            _close(got, want, dict(rtol=LOGITS_RTOL, atol=LOGITS_RTOL
                                   * float(np.abs(want).max())), what)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def test_checkpoint_from_1x4_restores_at_2x2_and_one_process(ranks):
    """granite's state after two steps at (1, 4), saved by the group,
    restores at (2, 2) over 4 ranks and on one process bit for bit
    (parameters, both moments and the step)."""
    saved = _train(ranks, ARCHS[0], (1, 4))[0]
    want = (saved["params"], saved["m"], saved["v"])
    for r in ranks[4]:
        got = r["restored"]
        for a, b in zip(got[:3], want):
            assert set(a) == set(b)
            assert all(_bits(a[n], b[n]) for n in a)
        assert got[3] == TW.STEPS
    cfg, params = TW.init(ARCHS[0])
    state = adamw_init(params, AdamWConfig(**TW.OPT))
    params, state = restore(ranks["ckpt"], TW.STEPS, (params, state),
                            device="cpu")
    one = ({n: p.detach().numpy() for n, p in params.named_parameters()},
           {n: t.numpy() for n, t in state.m.items()},
           {n: t.numpy() for n, t in state.v.items()})
    for a, b in zip(one, want):
        assert all(_bits(a[n], b[n]) for n in b)
    assert int(state.step) == TW.STEPS
