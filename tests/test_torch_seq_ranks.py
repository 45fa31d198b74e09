"""The decode caches' sequence over the model ranks, against the
reference package and the one-process port.

Where ``optim/sharding.py::cache_seq_block`` cuts an attention cache's
sequence dim (S_max, a window's slots, the encoder's frames) over the
model ranks, each rank holds its block for every KV head, as the
reference's ``decode_state_specs`` places it, and the decode reduces
the attention's softmax and its product with V over the ranks
(``models/attention.py``).  ONE group of 4 gloo ranks
(``tests/torch_seq_ranks_worker.py``, under a time limit) runs every
case, while ONE JAX subprocess with 4 forced CPU devices runs the
reference's ``make_serve_step`` jitted with the shardings of its
``decode_state_specs`` on a (1, 4) host mesh, as its dry run lowers a
decode cell (``src/repro/launch/dryrun.py:156-175``), but executed, for
qwen2-0.5b's smoke config and recurrentgemma-2b's at 3 layers (its one
attention layer stacked in the scan group, reference fault 10's
layers).  The subprocess writes its Gumbel noise first, and the ranks
read it once their own cases are done.

Tolerances:

* against the reference at (1, 4): its tokens given its noise, on every
  rank; each rank's vocabulary block of the prompt's last logits within
  rtol 1e-5, atol 1e-5 of the block's largest magnitude of the
  reference's, and of the first step's logits of the one-process port's
  (f32);
* against the one-process port in f64 at (1, 2), (1, 4) and (2, 2):
  the prompt's and every step's logits within rtol 1e-12, atol 1e-12
  of the case's largest magnitude; each rank's block of every attention
  cache, after the prefill's conversion and after every step, the
  one-process cache's block within the same tolerance of the cache's
  largest magnitude (the split products round otherwise), its
  ``pos_slots`` equal;
* placement and bytes: exact.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO
from repro_torch.core.mesh import Mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.launch.serve import state_from_prefill
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import sharding as S

import torch_seq_ranks_worker as W
from torch_lm_ref import ref_leaf

sys.path.insert(0, os.path.join(REPO, "tools"))
import chip_train_ranks as CT  # noqa: E402

RTOL = 1e-12
LOGITS_RTOL = 1e-5
TIMEOUT = 240

_REFERENCE = """
import dataclasses, os
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import jaxcompat
from repro.configs.base import get_config, smoke_config
from repro.launch.serve import state_from_prefill
from repro.models import model as M
from repro.optim.sharding import (decode_state_specs, input_specs_pytree,
                                  param_specs)
from repro.runtime.steps import make_serve_step
inp = dict(np.load({inp!r}))
key, subs, noise = jax.random.PRNGKey(1), [], []
for i in range({gen} - 1):
    key, sub = jax.random.split(key)
    subs.append(sub)
    noise.append(np.asarray(jax.random.gumbel(sub, ({b}, {k}), jnp.float32)))
np.save({noise_tmp!r}, np.stack(noise))
os.replace({noise_tmp!r}, {noise_path!r})

def key_of(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

mesh = jaxcompat.make_mesh((1, 4), ("data", "model"),
                           devices=jax.devices()[:4])
out = {{}}
for arch, changes in {archs!r}.items():
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **changes)
    like = jax.eval_shape(lambda k: M.init_params(k, cfg, max_seq={max_seq}),
                          jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(inp[arch + "/params/" + key_of(p)]), like)
    with jaxcompat.use_mesh(mesh):
        last, pst = M.prefill(params, cfg,
                              {{"tokens": jnp.asarray(inp[arch + "/tokens"])}})
        state = state_from_prefill(cfg, pst, {s_max})

        def shard(specs):
            return jax.tree.map(lambda s: NamedSharding(mesh, s), specs)
        sshard = shard(decode_state_specs(state, cfg, mesh, s_max={s_max}))
        tok = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
        tshard = NamedSharding(mesh, input_specs_pytree({{"t": tok}},
                                                        mesh)["t"])
        pshard = shard(param_specs(params, cfg, mesh))
        step = jax.jit(make_serve_step(cfg, mesh, k={k},
                                       batch_axes=("data",)),
                       in_shardings=(pshard, sshard, tshard,
                                     NamedSharding(mesh, P())),
                       out_shardings=(tshard, sshard))
        params = jax.device_put(params, pshard)
        state = jax.device_put(state, sshard)
        toks = [tok]
        tok = jax.device_put(tok, tshard)
        for sub in subs:
            tok, state = step(params, state, tok, sub)
            toks.append(tok)
    out[arch + "/tokens"] = np.concatenate([np.asarray(t) for t in toks], 1)
    out[arch + "/last"] = np.asarray(last)
np.savez({out_path!r}, **out)
print("REFERENCE_OK")
"""


def _reference_inputs():
    """The port's initial weights of each reference arch in the
    reference's tree, and its prompt."""
    inp = {}
    for arch, changes in W.REF_ARCHS.items():
        cfg, params = W.model(arch, changes, dtype=None)
        groups = {}
        for name, p in params.named_parameters():
            key, g = ref_leaf(name, cfg)
            groups.setdefault(key, {})[g] = p.detach().numpy()
        for key, v in groups.items():
            inp[f"{arch}/params/{key}"] = (v[None] if None in v else np.stack(
                [v[g] for g in range(len(v))]))
        inp[f"{arch}/tokens"] = W.ref_inputs(arch)
    return inp


@pytest.fixture(scope="module")
def pending_ref(tmp_path_factory):
    """The reference's subprocess, started first."""
    d = tmp_path_factory.mktemp("seq_ranks_ref")
    np.savez(d / "inp.npz", **_reference_inputs())
    code = _REFERENCE.format(
        inp=str(d / "inp.npz"), out_path=str(d / "out.npz"),
        noise_tmp=str(d / "noise_tmp.npy"), noise_path=str(d / "noise.npy"),
        gen=W.REF_GEN, b=W.B, k=W.REF_K, archs=W.REF_ARCHS,
        max_seq=W.MAX_SEQ, s_max=W.REF_PROMPT + W.REF_GEN)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(pending_ref):
    """The 4 ranks' outputs: every case at each layout, the collectives,
    then the reference's decodes once its noise is written."""
    _, d = pending_ref
    return spawn_ranks(W.run, 4, args=({"noise": str(d / "noise.npy")},),
                       timeout=TIMEOUT)


@pytest.fixture(scope="module")
def ref(pending_ref, ranks):
    proc, d = pending_ref
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "REFERENCE_OK" in out, out + err
    return dict(np.load(d / "out.npz")), np.load(d / "noise.npy")


@pytest.fixture(scope="module")
def one_process():
    """Every case on one process, no mesh; a ``PER_DATA_BLOCK`` case
    also on each data rank's rows of (2, 2) alone, keyed (name, rows)."""
    out = {name: W.decode_case(name) for name in W.CASES}
    for name in W.PER_DATA_BLOCK:
        for rows in np.split(np.arange(W.B), 2):
            out[(name, tuple(rows))] = W.decode_case(name, rows=rows)
    return out


def _one(one_process, name, g):
    """The one-process run rank ``g``'s rows are held to, and its rows
    that are ``g``'s: the whole batch's, but for a ``PER_DATA_BLOCK``
    case over data ranks, whose rows one process decodes alone."""
    key = (name, tuple(g["rows"]))
    if key in one_process:
        return one_process[key], np.arange(len(g["rows"]))
    return one_process[name], g["rows"]


def _close(got, want, rtol, scale, what):
    torch.testing.assert_close(torch.from_numpy(np.asarray(got)),
                               torch.from_numpy(np.asarray(want)),
                               rtol=rtol, atol=rtol * scale, msg=what)


def _block(whole, got, coord, rows):
    """The rank's block of a one-process cache leaf ``whole``: its rows,
    and the block of the sequence dim (dim 1; a 1-D ``pos_slots`` its
    only dim) that ``got`` holds, from the model index."""
    m = coord[1]
    if whole.ndim == 1:
        n = got.shape[0]
        return whole[m * n:(m + 1) * n]
    whole = whole[rows]
    n = got.shape[1]
    return whole if n == whole.shape[1] else whole[:, m * n:(m + 1) * n]


def _attn(key):
    return "/self/" in key or "/cross/" in key


def _cases(ranks, name, lay):
    return [r[(name, lay)] for r in ranks if (name, lay) in r]


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(W.REF_ARCHS))
def test_decode_over_1x4_gives_the_references_tokens(ref, ranks, arch):
    """The port's decode over (data 1, model 4) ranks, each rank holding
    its quarter of the cache's sequence (the window's 32 slots for
    recurrentgemma-2b, wrapped while it decodes): the reference's tokens
    from its serve step jitted with ``decode_state_specs``' shardings,
    given its noise, on every rank."""
    out, _ = ref
    for r in ranks:
        got = r[("reference", arch)]
        assert got["split"] == {"self": 32 if "gemma" in arch else 36}
        np.testing.assert_array_equal(got["tokens"], out[f"{arch}/tokens"])


@pytest.mark.parametrize("arch", sorted(W.REF_ARCHS))
def test_decode_logits_blocks_at_1x4(ref, ranks, arch):
    """Each rank's vocabulary block of the prompt's last logits (the
    reference's columns) and of the first step's logits over the cut
    caches (the one-process port's columns): rtol 1e-5, atol 1e-5 of the
    block's largest magnitude."""
    out, _ = ref
    cfg, params = W.model(arch, W.REF_ARCHS[arch], dtype=None)
    tokens = torch.from_numpy(W.ref_inputs(arch))
    last, pst = M.prefill(params, cfg, {"tokens": tokens})
    state = state_from_prefill(cfg, pst, W.REF_PROMPT + W.REF_GEN)
    tok = M.argmax_vocab(last, cfg)[:, None].to(torch.int32)
    first, _ = M.decode_step(params, cfg, state, tok)
    part = cfg.padded_vocab() // 4
    for r in ranks:
        got = r[("reference", arch)]
        cols = slice(got["coord"][1] * part, (got["coord"][1] + 1) * part)
        for have, want, what in (
                (got["last"], out[f"{arch}/last"][:, cols], "prefill"),
                (got["first"], first[:, 0, cols].numpy(), "step")):
            _close(have, want, LOGITS_RTOL, float(np.abs(want).max()), what)


# --------------------------------------------------------------------------
# against the one-process port, in f64
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lay", W.LAYOUTS, ids=str)
@pytest.mark.parametrize("name", sorted(W.CASES))
def test_f64_decode_matches_one_process(ranks, one_process, name, lay):
    """One case's prefill and teacher-forced steps over ``lay`` ranks in
    f64: GQA with its heads split (qwen2-0.5b: the KV heads too at 2
    model ranks, ``w_k`` / ``w_v`` whole at 4; 12 query heads over 3 KV
    heads, the ranks' KV heads overlapping, 1, 2, 2 and 1 at 4 ranks)
    and with its heads whole (8 model peers), MLA (minicpm3-4b), the encoder-decoder's self and
    cross caches (whisper-large-v3), the window (recurrentgemma-2b, its
    ring partly empty and then wrapped) and expert-parallel MoE
    (granite-moe-1b-a400m; over data ranks against one process's decode
    of each data rank's rows, as MoE's capacity is a data shard's).  The
    prompt's and each
    step's logits blocks, and each rank's block of every attention cache
    after the prefill and after each step, are the one-process port's.
    Positions 3 to 8 cross from the first block to the next (blocks of
    4 or 8 of S_max 16) while the later blocks are wholly masked: their
    ranks add zeros and no NaN."""
    one = one_process[name]
    got = _cases(ranks, name, lay)
    assert len(got) == (2 if lay == (1, 2) else 4)
    scale = max(float(np.abs(x).max()) for x in [one["last"]]
                + one["logits"])
    s_max = W.CASES[name][5]
    want_split = {"self": 32 if name.startswith("window") else s_max}
    if name == "cross":
        want_split["cross"] = 16
    for g in got:
        assert g["split"] == want_split
        ref, rows = _one(one_process, name, g)
        part = g["last"].shape[1]
        cols = slice(g["coord"][1] * part, (g["coord"][1] + 1) * part)
        for i, (have, want) in enumerate(zip([g["last"]] + g["logits"],
                                             [ref["last"]] + ref["logits"])):
            assert np.isfinite(have).all()
            _close(have, want[rows][:, cols], RTOL, scale, f"logits {i}")
        for i, (snap, whole) in enumerate(zip(g["caches"], ref["caches"])):
            for key, t in snap.items():
                if not _attn(key):
                    continue
                want = _block(whole[key], t, g["coord"], rows)
                if key.endswith("pos_slots"):
                    np.testing.assert_array_equal(t, want)
                    continue
                _close(t, want, RTOL, float(np.abs(whole[key]).max()),
                       f"{key} after step {i}")


def test_the_cases_reach_every_position_kind():
    """The f64 cases' positions, from their constants: at 4 model ranks a
    step whose position lies in rank 0's block (ranks 1 to 3 wholly
    masked), a block's last slot and the next block's first; a window
    ring with a rank's block of slots still empty, and one that has
    wrapped."""
    _, _, _, prompt, steps, s_max = W.CASES["gqa_split_heads"]
    pos = range(prompt, prompt + steps)
    for m in (2, 4):
        n = s_max // m
        assert pos[0] < n and n - 1 in pos and n in pos
    w = 32
    _, _, _, prompt, steps, _ = W.CASES["window_fill"]
    assert prompt + steps <= w - w // 4          # the last rank's empty
    _, _, _, prompt, steps, _ = W.CASES["window_wrap"]
    assert prompt < w < prompt + steps


# --------------------------------------------------------------------------
# placement and bytes
# --------------------------------------------------------------------------

def _whole_state(name):
    """The case's state on one process after the prefill (the whole
    batch and sequence)."""
    arch, changes, _, prompt, _, s_max = W.CASES[name]
    cfg, params = W.model(arch, changes)
    batch = {k: torch.from_numpy(v) for k, v in W.case_inputs(name).items()}
    batch["tokens"] = batch["tokens"][:, :prompt]
    _, pst = M.prefill(params, cfg, batch)
    return cfg, state_from_prefill(cfg, pst, s_max,
                                   cache_dtype=torch.float64), s_max


def _specs_by_key(specs):
    out = {}
    for i, layer in enumerate(specs.caches):
        for key, c in layer.items():
            for f, sp in (c._asdict().items() if hasattr(c, "_fields")
                          else [("", c)]):
                out[f"{i}/{key}/{f}".rstrip("/")] = sp
    return out


@pytest.mark.parametrize("lay", W.LAYOUTS, ids=str)
def test_cache_leaves_hold_the_specs_blocks(ranks, lay):
    """Each rank's attention cache leaves, in every case, hold exactly the
    block that ``decode_state_layout`` gives over the (data, model) rank
    mesh, and that block is ``decode_state_specs``' (the reference's
    rule), but for the ``pos_slots`` of a window cache the reference
    stacks, which the reference's spec puts on the batch axes (fault
    10) and the port's layout on its ``k``'s window dim; the leaves'
    bytes are the specs' bytes."""
    for name in sorted(W.CASES):
        arch, _, msize, *_ = W.CASES[name]
        cfg, whole, s_max = _whole_state(name)
        mesh_shape = {"data": lay[0], "model": msize or lay[1]}
        specs = _specs_by_key(S.decode_state_specs(whole, cfg, mesh_shape,
                                                   s_max=s_max))
        layout = _specs_by_key(CT.decode_state_layout(
            whole, cfg, mesh_shape, s_max=s_max))
        shapes = W.leaves(whole)
        ranks_of = {"data": lay[0], "model": lay[1]}
        for g in _cases(ranks, name, lay):
            for key, t in g["caches"][0].items():
                if not _attn(key):
                    continue
                want = tuple(
                    n // int(np.prod([ranks_of[a] for a in S._names(e)]))
                    for n, e in zip(shapes[key].shape, layout[key]))
                assert t.shape == want, (name, key)
                if key.endswith("pos_slots"):      # every one stacked here
                    assert layout[key] == ("model",)
                    assert specs[key] == ("data",)
                else:
                    assert layout[key] == specs[key], (name, key)
                    assert layout[key][1] == "model", (name, key)


def test_fault_10_pos_slots_differ_from_the_spec_at_2x2(ranks):
    """recurrentgemma-2b's stacked attention layer at (2, 2): the
    reference's spec cuts ``pos_slots`` over ``data``, so a rank at
    (data d, model m) would hold slots ``[16 d, 16 d + 16)``; it holds
    ``[16 m, 16 m + 16)``, the slots of its block of ``k``, which the
    ranks at d != m tell apart."""
    _, whole, _ = _whole_state("window_wrap")
    slots = W.leaves(whole)["2/self/pos_slots"]
    seen = 0
    for g in _cases(ranks, "window_wrap", (2, 2)):
        d, m = g["coord"]
        got = g["caches"][0]["2/self/pos_slots"]
        np.testing.assert_array_equal(got, slots[16 * m:16 * m + 16])
        if d != m:
            assert not np.array_equal(got, slots[16 * d:16 * d + 16])
            seen += 1
    assert seen == 2


@pytest.mark.parametrize("lay", W.LAYOUTS, ids=str)
def test_decode_step_bytes_are_the_reckoning(ranks, lay):
    """Every decode step of every case delivers over the model axis
    exactly the bytes ``model_axis_events(mode="decode")`` reckons (the
    split products' sums and, where a cache's sequence is cut, the
    query heads' and the new k / v's gathers, the maximum, the two sums
    or their reduce-scatter), and nothing over the data axis."""
    for name in sorted(W.CASES):
        arch, changes, msize, _, steps, s_max = W.CASES[name]
        cfg, _ = W.model(arch, changes)
        want = CT.model_axis_bytes(CT.model_axis_events(
            cfg, "decode", W.B // lay[0], s_max, msize or lay[1], lay[1]),
            lay[1])["sent"]
        for g in _cases(ranks, name, lay):
            assert g["sent"] == [{"data": 0, "model": want}] * steps, name


# --------------------------------------------------------------------------
# the collectives and one process
# --------------------------------------------------------------------------

def test_max_and_all_to_all_over_model_ranks(ranks):
    """``max_over_model`` and ``all_to_all`` over the 4 model ranks: the
    elementwise maximum of every rank's term (every rank the same bits,
    2 (n - 1) / n of the operand sent), and the blocks exchanged, rank
    j's block i on rank i at place j ((n - 1) / n sent)."""
    terms = [W.term(r) for r in range(4)]
    for r, res in enumerate(ranks):
        got = res["collectives"]
        np.testing.assert_array_equal(got["max"],
                                      np.max(np.stack(terms), axis=0))
        np.testing.assert_array_equal(got["a2a"], np.concatenate(
            [t[:, 2 * r:2 * r + 2] for t in terms], axis=2))
        assert got["max_sent"] == 2 * 3 * terms[0].nbytes // 4
        assert got["a2a_sent"] == 3 * terms[0].nbytes // 4


def test_one_process_is_unchanged():
    """On one process, over a virtual 16-peer model axis too, no cache is
    cut (``cache_seq_block`` is None, ``seq_split`` empty), the caches
    keep their whole shapes, and a decode step under the mesh gives the
    bits it gives without one."""
    cfg, params = W.model("qwen2-0.5b", {})
    mesh = Mesh((1, 16), ("data", "model"), "cpu")
    assert S.cache_seq_block(32, mesh) is None
    with L.use_mesh(mesh):
        st = M.init_decode_state(cfg, batch=2, s_max=32, device="cpu",
                                 cache_dtype=torch.float32)
    plain = M.init_decode_state(cfg, batch=2, s_max=32, device="cpu",
                                cache_dtype=torch.float32)
    assert st.seq_split == {} and W.leaves(st).keys() == \
        W.leaves(plain).keys()
    assert all(a.shape == b.shape for a, b in zip(
        W.leaves(st).values(), W.leaves(plain).values()))
    batch = {"tokens": torch.from_numpy(W.ref_inputs("qwen2-0.5b"))}
    _, pst = M.prefill(params, cfg, batch)
    outs = []
    for m in (mesh, None):
        with L.use_mesh(m):
            state = state_from_prefill(cfg, pst, 40,
                                       cache_dtype=torch.float64)
            logits, state = M.decode_step(params, cfg, state,
                                          batch["tokens"][:, :1])
        outs.append((logits, W.leaves(state)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(np.array_equal(outs[0][1][k], outs[1][1][k])
               for k in outs[0][1])
