"""Training and serving across ranks against the reference package and
the one-process mesh.

The reference's outputs come from ONE JAX subprocess with 4 forced CPU
devices (an ``.npz``), started first and run while the ranks do: the
reference's train step (2 microbatches, 2 steps on ``SyntheticLM``)
of granite-moe-1b-a400m's and qwen2-0.5b's smoke configs on the host
meshes (1, 1), (2, 1), (2, 2) and (4, 1), each from the port's own
initial weights (handed over in the reference's tree), and granite's
decode on the (2, 2) mesh (``make_serve_step`` under the mesh, as
``serve decode --model-par 2`` runs it on 4 devices) with each step's
Gumbel noise.  The port runs the same steps on one process with
virtual data peers (``Mesh((2, 2))``, MoE dispatched per data shard)
and over 2 and 4 gloo ranks (``tests/torch_train_ranks_worker.py``,
spawned by ``launch.ranks.spawn_ranks`` with a time limit).

Bits: every rank ends with the same parameters and the same loss and
norm bits, and the one-process (2, 1) and (2, 2) meshes give the same
bits (a model axis of virtual peers inside one process changes no
arithmetic).  The ranks are NOT bit-equal to the one-process mesh: a
weight gradient sums the products of all of a microbatch's tokens in
one GEMM on one process, and each rank's tokens first and then the
ranks' sums over ranks; over model ranks the products are split
(attention heads, FFN columns, experts, the vocabulary block) and
their partial results summed over the ranks
(``tests/test_torch_model_ranks.py``), so the rounding differs; both
are held to the reference within loss rtol 1e-5 and parameters rtol
1e-4 / atol 1e-5, and to each other within the same.  Checkpoints are
global leaves, so they restore across layouts bit for bit.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO
from repro_torch.ckpt.checkpoint import restore, save
from repro_torch.core.mesh import Mesh
from repro_torch.launch import serve, train as train_cli
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.optim.adamw import AdamWConfig, adamw_init

import torch_train_ranks_worker as W
from torch_lm_ref import ref_leaf

ARCHS = ("granite-moe-1b-a400m", "qwen2-0.5b")
SHAPES = ((1, 1), (2, 1), (2, 2), (4, 1))
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
#: the gradient's norm: AdamW's update is blind to the whole gradient's
#: scale (and the clip makes it unit-norm), so the norm is what holds a
#: reduce that scales every gradient by a constant
NORM_TOL = dict(rtol=1e-4, atol=0.0)
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

def flat(prefix, tree):
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + key_of(path)] = np.asarray(a)

def weights(arch, cfg):
    like = jax.eval_shape(lambda k: M.init_params(k, cfg, max_seq={max_seq}),
                          jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(inp[arch + "/params/" + key_of(p)]), like)

def mesh_of(shape):
    n = shape[0] * shape[1]
    return jaxcompat.make_mesh(shape, ("data", "model"),
                               devices=jax.devices()[:n])

ocfg = AdamWConfig(**{opt!r})
for arch in {archs!r}:
    cfg = smoke_config(get_config(arch))
    params0 = weights(arch, cfg)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len={seq},
                       global_batch={b})
    for shape in {shapes!r}:
        mesh = mesh_of(shape)
        tag = f"{{arch}}/{{shape[0]}}x{{shape[1]}}"
        with jaxcompat.use_mesh(mesh):
            shard = jax.tree.map(lambda s: NamedSharding(mesh, s),
                                 param_specs(params0, cfg, mesh))
            p = jax.device_put(params0, shard)
            st = adamw_init(p, ocfg)
            step = jax.jit(make_train_step(
                cfg, ocfg, microbatches={micro}, remat="none",
                batch_axes=batch_axes(dict(mesh.shape))))
            for i in range({steps}):
                p, st, om = step(p, st, device_put_batch(data.batch_at(i),
                                                         mesh))
                out[f"{{tag}}/loss/{{i}}"] = np.asarray(om["loss"])
                out[f"{{tag}}/grad_norm/{{i}}"] = np.asarray(om["grad_norm"])
            flat(f"{{tag}}/params", p)

# granite's decode as serve decode --model-par 2 runs it on 4 devices
cfg = smoke_config(get_config({dec_arch!r}))
params = weights({dec_arch!r}, cfg)
mesh = mesh_of((2, 2))
with jaxcompat.use_mesh(mesh):
    batch = {{"tokens": jnp.asarray(inp["decode/tokens"])}}
    last, pst = M.prefill(params, cfg, batch)
    state = state_from_prefill(cfg, pst, {dec_prompt} + {dec_gen})
    serve_step = jax.jit(make_serve_step(cfg, mesh, k={dec_k},
                                         batch_axes=("data",)))
    tok = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
    toks, noise = [tok], []
    key = jax.random.PRNGKey(1)
    for i in range({dec_gen} - 1):
        key, sub = jax.random.split(key)
        noise.append(jax.random.gumbel(sub, ({dec_b}, {dec_k}), jnp.float32))
        tok, state = serve_step(params, state, tok, sub)
        toks.append(tok)
out["decode/noise"] = np.stack([np.asarray(n) for n in noise])
out["decode/out"] = np.concatenate([np.asarray(t) for t in toks], axis=1)
np.savez({out_path!r}, **out)
print("REFERENCE_OK")
"""


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _reference_tree(arch):
    """The port's initial weights in the reference's tree, flattened by
    key: a stacked layer's leaves stacked over its scan group."""
    cfg, params = W.init(arch)
    groups = {}
    for name, p in params.named_parameters():
        key, g = ref_leaf(name, cfg)
        groups.setdefault(key, {})[g] = p.detach().numpy()
    return {f"{arch}/params/{key}": (v[None] if None in v else np.stack(
        [v[g] for g in range(len(v))])) for key, v in groups.items()}


@pytest.fixture(scope="module")
def pending_ref(tmp_path_factory):
    """The reference's subprocess, started first: (process, out path)."""
    d = tmp_path_factory.mktemp("train_ranks_ref")
    inp = {}
    for arch in ARCHS:
        inp.update(_reference_tree(arch))
    rng = np.random.default_rng(27)
    inp["decode/tokens"] = rng.integers(
        0, 512, (W.DEC_B, W.DEC_PROMPT)).astype(np.int32)
    np.savez(d / "inp.npz", **inp)
    code = _REFERENCE.format(
        inp=str(d / "inp.npz"), out_path=str(d / "out.npz"),
        max_seq=W.MAX_SEQ, opt=W.OPT, archs=ARCHS, seq=W.SEQ, b=W.B,
        shapes=SHAPES, micro=W.MICRO, steps=W.STEPS, dec_arch=ARCHS[0],
        dec_prompt=W.DEC_PROMPT, dec_gen=W.DEC_GEN, dec_k=W.DEC_K,
        dec_b=W.DEC_B)
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
def one_process(pending_ref, tmp_path_factory):
    """The port's steps on one process at each mesh shape (virtual
    peers), and a checkpoint of the (2, 2) granite state it wrote."""
    d = tmp_path_factory.mktemp("ckpt_one")
    out = {}
    for arch in ARCHS:
        for shape in SHAPES:
            mesh = Mesh(shape, ("data", "model"), "cpu")
            cfg, params = W.init(arch)
            state = adamw_init(params, AdamWConfig(**W.OPT))
            params, state, res = W.train_steps(arch, mesh, cfg, params,
                                               None, state)
            res["params"] = {n: p.detach().numpy().copy()
                             for n, p in params.named_parameters()}
            if (arch, shape) == (ARCHS[0], (2, 2)):
                save(str(d), W.STEPS, (params, state))
                res["m"] = {n: t.numpy().copy() for n, t in state.m.items()}
                res["v"] = {n: t.numpy().copy() for n, t in state.v.items()}
            out[(arch, shape)] = res
    out["ckpt"] = str(d)
    return out


@pytest.fixture(scope="module")
def ranks(pending_ref, one_process, tmp_path_factory):
    """World 4 at (2, 2) and (4, 1), which saves granite's (2, 2) state;
    then world 2 at (2, 1), which also restores that checkpoint and the
    one-process one onto (2, 1); then a one-process restore."""
    d4 = str(tmp_path_factory.mktemp("ckpt_ranks4"))
    r4 = spawn_ranks(W.train, 4, args=(dict(
        archs=ARCHS, layouts=((2, 2), (4, 1)),
        ckpt=(d4, ARCHS[0], (2, 2))),), timeout=TIMEOUT)
    r2 = spawn_ranks(W.train, 2, args=(dict(
        archs=ARCHS, layouts=((2, 1),)),), timeout=TIMEOUT)
    back2 = spawn_ranks(W.restore_onto, 2, args=(dict(
        arch=ARCHS[0], layout=(2, 1), dirs=(d4, one_process["ckpt"])),),
        timeout=TIMEOUT)
    back4 = spawn_ranks(W.restore_onto, 4, args=(dict(
        arch=ARCHS[0], layout=(2, 2), dirs=(one_process["ckpt"],)),),
        timeout=TIMEOUT)
    return {4: r4, 2: r2, "dir4": d4, "back2": back2, "back4": back4}


@pytest.fixture(scope="module")
def ref(pending_ref, ranks):
    proc, path, inp = pending_ref
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0 and "REFERENCE_OK" in out, out + err
    return inp, dict(np.load(path))


def _ref_params(out, arch, shape, name):
    cfg, _ = W.init(arch)
    key, g = ref_leaf(name, cfg)
    a = out[f"{arch}/{_tag(shape)}/params/{key}"]
    return a if g is None else a[g]


def _close(got, want, tol, what):
    torch.testing.assert_close(torch.from_numpy(np.asarray(got)),
                               torch.from_numpy(np.asarray(want)), **tol,
                               msg=what)


#: leaves whose gradient is zero in exact arithmetic: a key bias adds
#: q . b_k to every logit of a query's row, which the softmax cancels.
#: Their gradient is rounding noise, and AdamW's first steps move them
#: by about lr times the noise's sign whatever its size, so two sums in
#: different orders (the ranks' and the reference's) need not agree to
#: the tolerance; they are held to that bound instead.
ZERO_GRAD = (".mixer.b_k",)


def _close_params(got, want_of, what):
    """Every parameter of ``got`` within PARAM_TOL of ``want_of(name)``;
    the names of all that are not, in one failure.  A ZERO_GRAD leaf
    is held to the bound of two such moves apart."""
    bad = []
    for name, p in got.items():
        want = want_of(name)
        if name.endswith(ZERO_GRAD):
            # each side moves at most 2 lr a step (Adam's bias-corrected
            # ratio stays below 2 over two steps; no decay on a zero bias)
            bound = 2 * W.STEPS * 2 * W.OPT["lr"]
            assert np.abs(p - want).max() <= bound, (what, name)
            continue
        if not np.allclose(p, want, **PARAM_TOL):
            err = np.abs(p - want) - PARAM_TOL["rtol"] * np.abs(want)
            bad.append((name, float(err.max())))
    assert not bad, (what, bad)


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_process_mesh_matches_reference(ref, one_process, arch, shape):
    """One process with virtual data peers: MoE dispatches each data
    shard alone (capacity and aux per shard), as the reference does on
    the same host mesh; losses, norms and parameters after 2 steps."""
    _, out = ref
    res = one_process[(arch, shape)]
    for i in range(W.STEPS):
        _close(res["loss"][i], out[f"{arch}/{_tag(shape)}/loss/{i}"],
               LOSS_TOL, f"loss {i}")
        _close(res["grad_norm"][i],
               out[f"{arch}/{_tag(shape)}/grad_norm/{i}"],
               NORM_TOL, f"grad_norm {i}")
    _close_params(res["params"], lambda n: _ref_params(out, arch, shape, n),
                  "reference")


def test_data_shards_change_granites_loss(ref, one_process):
    """Per-shard capacity and aux move granite's loss: the (1, 1) and
    (4, 1) losses differ in both packages, by the same amount within
    the tolerance; the dense qwen2-0.5b's do not differ beyond it; the
    model axis changes no bit."""
    _, out = ref
    g, q = ARCHS
    one = one_process
    assert abs(float(one[(g, (1, 1))]["loss"][0])
               - float(one[(g, (4, 1))]["loss"][0])) > 1e-3
    assert abs(float(out[f"{g}/1x1/loss/0"])
               - float(out[f"{g}/4x1/loss/0"])) > 1e-3
    _close(one[(q, (1, 1))]["loss"][0], one[(q, (4, 1))]["loss"][0],
           LOSS_TOL, "qwen2 loss")
    for arch in ARCHS:
        a, b = one[(arch, (2, 1))], one[(arch, (2, 2))]
        assert _bits(a["loss"], b["loss"])
        assert all(_bits(a["params"][n], b["params"][n])
                   for n in a["params"])


@pytest.mark.parametrize("case", [(2, (2, 1)), (4, (2, 2)), (4, (4, 1))])
@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_match_reference_and_one_process(ref, ranks, one_process,
                                               arch, case):
    """Over 2 and 4 gloo ranks: every rank's loss and norm bits are the
    same, its losses, gradient norms and gathered parameters after 2
    steps are within the tolerance of the reference's on that host mesh
    and of the one-process mesh's (not bit-equal to it: see the module
    docstring), and each rank holds blocks of the specs' shapes."""
    _, out = ref
    world, shape = case
    got = [r[(arch, shape)] for r in ranks[world]]
    one = one_process[(arch, shape)]
    for r in got:
        assert _bits(r["loss"], got[0]["loss"])
        assert _bits(r["grad_norm"], got[0]["grad_norm"])
        for name, p in r["params"].items():
            assert _bits(p, got[0]["params"][name]), name
    for i in range(W.STEPS):
        _close(got[0]["loss"][i], out[f"{arch}/{_tag(shape)}/loss/{i}"],
               LOSS_TOL, f"loss {i}")
        _close(got[0]["loss"][i], one["loss"][i], LOSS_TOL, f"loss {i}")
        _close(got[0]["grad_norm"][i],
               out[f"{arch}/{_tag(shape)}/grad_norm/{i}"], NORM_TOL,
               f"grad_norm {i}")
        _close(got[0]["grad_norm"][i], one["grad_norm"][i], NORM_TOL,
               f"grad_norm {i}")
    _close_params(got[0]["params"],
                  lambda n: _ref_params(out, arch, shape, n), "reference")
    _close_params(got[0]["params"], lambda n: one["params"][n],
                  "one process")
    assert any(got[0]["block_shapes"][n] != one["params"][n].shape
               for n in one["params"])
    assert got[0]["bytes"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_unequal_label_masks_over_ranks(arch):
    """Labels of -1 that leave the data ranks unequal counts of
    labelled tokens: each microbatch's cross-entropy is divided by the
    whole microbatch's count (the ranks' counts summed first), so the
    4 ranks' loss, gradient norm and parameters after a step are the
    one-process (2, 2) mesh's within the tolerance (a mean of the
    ranks' means would not be)."""
    outs = spawn_ranks(W.masked, 4, args=(dict(arch=arch, layout=(2, 2)),),
                       timeout=TIMEOUT)
    cfg, params = W.init(arch)
    mesh = Mesh((2, 2), ("data", "model"), "cpu")
    step = W.make_train_step(cfg, AdamWConfig(**W.OPT), microbatches=W.MICRO,
                             remat="none", mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in W.masked_batch(cfg).items()}
    params, _, om = step(params, adamw_init(params, AdamWConfig(**W.OPT)),
                         batch)
    for loss, norm, got in outs:
        assert _bits(loss, outs[0][0]) and _bits(norm, outs[0][1])
        _close(loss, om["loss"].numpy(), LOSS_TOL, "loss")
        _close(norm, om["grad_norm"].numpy(), NORM_TOL, "grad_norm")
        _close_params(got, lambda n: dict(params.named_parameters())[n]
                      .detach().numpy(), "one process")


def _same_tree(a, b):
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for n in x:
            assert _bits(x[n], y[n]), n


def test_checkpoints_restore_across_layouts(ranks, one_process):
    """A checkpoint written by 4 ranks at (2, 2) restores onto 2 ranks
    at (2, 1) and onto one process bit for bit (parameters and both
    moments, the step too); one written by one process restores onto 2
    and onto 4 ranks."""
    saved4 = ranks[4][0][(ARCHS[0], (2, 2))]
    want4 = (saved4["params"], saved4["m"], saved4["v"])
    d4, d1 = ranks["dir4"], one_process["ckpt"]
    for r in ranks["back2"]:
        _same_tree(r[d4][:3], want4)
        assert r[d4][3] == W.STEPS
    cfg, params = W.init(ARCHS[0])
    state = adamw_init(params, AdamWConfig(**W.OPT))
    params, state = restore(d4, W.STEPS, (params, state), device="cpu")
    _same_tree(({n: p.detach().numpy() for n, p in
                 params.named_parameters()},
                {n: t.numpy() for n, t in state.m.items()},
                {n: t.numpy() for n, t in state.v.items()}), want4)
    one = one_process[(ARCHS[0], (2, 2))]
    want1 = (one["params"], one["m"], one["v"])
    for r in ranks["back2"]:
        _same_tree(r[d1][:3], want1)
    for r in ranks["back4"]:
        _same_tree(r[d1][:3], want1)


@pytest.fixture(scope="module")
def decoded(ref):
    """granite's smoke decode on (2, 2): one process (virtual peers) and
    4 ranks, each given the reference's noise."""
    inp, out = ref
    cfg, params = W.init(ARCHS[0])
    mesh = Mesh((2, 2), ("data", "model"), "cpu")
    one = W.decode(cfg, params, mesh, torch.from_numpy(inp["decode/tokens"]),
                   torch.from_numpy(out["decode/noise"]))
    r4 = spawn_ranks(W.decode_ranks, 4, args=(dict(
        arch=ARCHS[0], layout=(2, 2), tokens=inp["decode/tokens"],
        noise=out["decode/noise"]),), timeout=TIMEOUT)
    return out["decode/out"], one, r4


def test_decode_over_ranks_gives_reference_tokens(decoded):
    """granite's (2, 2) decode tokens: the reference's (MoE per data
    shard in prefill and decode, FD over the model axis), the
    one-process mesh's and every rank's."""
    want, one, r4 = decoded
    np.testing.assert_array_equal(one, want)
    for toks in r4:
        np.testing.assert_array_equal(toks, want)


def test_make_elastic_mesh_over_ranks():
    """3 ranks of model 1: the first 2 form a (2, 1) mesh, the third is
    left out (None); every rank makes the subgroup."""
    outs = spawn_ranks(W.elastic, 3, timeout=TIMEOUT)
    assert outs[:2] == [({"data": 2, "model": 1}, r) for r in (0, 1)]
    assert outs[2] is None


def test_a_failed_rank_stops_the_group_and_all_resume(tmp_path):
    """``run_with_recovery`` over 2 ranks: rank 1 fails at step 3, after
    the step-2 checkpoint, and the group stops (no retry: its peer may
    wait in a collective); a rerun restores every rank from step 2 (rank
    0's, broadcast) and runs to step 5."""
    conf = dict(dir=str(tmp_path), steps=5, fail_at=3)
    with pytest.raises(RuntimeError, match="rank 1 fails at step 3"):
        spawn_ranks(W.recover, 2, args=(conf,), timeout=TIMEOUT)
    outs = spawn_ranks(W.recover, 2, args=(dict(conf, fail_at=-1),),
                       timeout=TIMEOUT)
    for start, w in outs:
        assert start == 2
        np.testing.assert_array_equal(w, np.full(3, 5.0, np.float32))


def test_train_cli_over_ranks(tmp_path, capfd):
    """``launch.train --ranks 4 --model-par 2`` on the CPU: the
    reference's lines from rank 0 (``mesh={'data': 2, 'model': 2}
    devices=4``), every step logged; a second call with a checkpoint
    directory resumes every rank from step 2."""
    argv = ["--smoke", "--device", "cpu", "--ranks", "4", "--model-par",
            "2", "--batch", "8", "--seq", "32", "--microbatches", "2",
            "--log-every", "1", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--arch", ARCHS[0]]
    losses = train_cli.main(argv + ["--steps", "2"])
    text = capfd.readouterr().out
    assert re.search(r"^arch=granite-moe-1b-a400m params=[\d,]+ "
                     r"mesh=\{'data': 2, 'model': 2\} devices=4$", text,
                     re.M), text
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert len(re.findall(r"^step +\d+  loss", text, re.M)) == 2
    losses = train_cli.main(argv + ["--steps", "3"])
    text = capfd.readouterr().out
    assert "resumed from step 2" in text and len(losses) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decode_cli_over_ranks(arch, capfd):
    """``serve decode --ranks 4 --model-par 2`` on the CPU: the tokens of
    the one-process decode on the same (2, 2) mesh (``decode_run`` with
    2 virtual data peers), the reference's two lines from rank 0."""
    argv = ["decode", "--smoke", "--device", "cpu", "--arch", arch,
            "--gen", "6", "--prompt-len", "8", "--model-par", "2"]
    got = serve.main(argv + ["--ranks", "4"])
    text = capfd.readouterr().out
    assert f"arch={arch} policy=fd-dynamic" in text
    assert "sample tokens:" in text
    want = serve.decode_run(argv[1:], data=2)["tokens"]
    np.testing.assert_array_equal(got, want)


def test_chip_smoke_phase_16_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py phase 16 (``_train_serve_ranks`` and
    ``tools/chip_train_ranks.py``) on 4 gloo ranks of the CPU path at
    the smoke configs: every check it makes on the card passes (the
    ranks' loss and norm bits, the leaves' replicas, the bytes a step ==
    the specs' count, the f32 step against one process, the checkpoint
    onto 2 ranks and one process, the decodes' tokens == one process's
    data block by data block, and here also the whole batch's)
    but the kernels' launches, which the CPU path does not make."""
    sys.path.insert(0, REPO)
    import chip_smoke as C
    from repro_torch.kernels import _build
    monkeypatch.setattr(C, "TRAIN_B", 8)
    monkeypatch.setattr(C, "TRAIN_SEQ", 32)
    monkeypatch.setattr(C, "DEC_GEN", 5)
    monkeypatch.setattr(C, "_decode_argv", lambda arch: [
        "decode", "--arch", arch, "--smoke", "--batch", "4",
        "--prompt-len", "8", "--gen", "5", "--model-par", "16",
        "--device", "cpu"])
    launches = C._train_serve_ranks(torch.device("cpu"), "cpu", _build)
    text = capsys.readouterr().out
    assert set(launches) == set(_build.LAUNCHES)
    assert "the same bits on every rank" in text
    assert "restored onto 2 ranks and onto one process bit for bit" in text
    assert text.count("== one process's, data block by data block") == 2
    # on the CPU the products' rounding does not depend on the batch: the
    # whole batch's one-process decode agrees too
    assert text.count("(first difference at step None)") == 2
