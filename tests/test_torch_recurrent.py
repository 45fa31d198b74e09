"""The port's recurrent mixers and sliding-window attention against the
reference package.

RWKV-6 (rwkv6-3b) and Griffin (recurrentgemma-2b) at their smoke
configs (f32); recurrentgemma's smoke config has 2 layers, both RG-LRU,
so its model runs at ``n_layers=5``: one ``("rglru", "rglru", "attn")``
group and two remainder layers, the attention layer's window 32 slots.

- RWKV: ``rwkv6_scan``; ``rwkv6_chunked`` at T < chunk, T == chunk and T
  not a multiple of the chunk, and against the scan; ``apply_rwkv`` in
  prefill and decode from a non-zero state and token-shift carry;
  ``apply_rwkv_cmix`` with a non-zero carry;
- Griffin: ``rglru`` in prefill (the log-depth scan) and decode from a
  non-zero ``h0``; ``apply_griffin`` with a carried conv buffer in both;
  ``_block_diag``;
- the window: ``gqa_decode_window`` over 7 steps of a 4-slot ring;
  ``state_from_prefill``'s window conversion after prompts of 10 and 40
  tokens (shorter and longer than the 32-slot window);
- the model, with the reference's weights carried across by
  ``params_from_reference``: ``count_params``, ``forward`` logits,
  ``prefill`` logits and caches, ``state_from_prefill`` and 4
  teacher-forced ``decode_step``s (the 40-token prompt's steps overwrite
  ring slots 8 to 11).

Every JAX output comes from ONE subprocess (an ``.npz``); inputs are
made with numpy from a seed.  Tolerance: ``torch.testing.assert_close(
rtol=1e-4, atol=1e-5)`` on f32 outputs.
"""
import dataclasses

import numpy as np
import pytest
import torch
from conftest import run_with_devices
from torch_lm_ref import (MAX_SEQ, REFERENCE_HEAD, TOL, close, close_all,
                          close_caches, params_of, t, tree)

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.launch.serve import state_from_prefill
from repro_torch.models import attention as A
from repro_torch.models import griffin, rwkv
from repro_torch.models import layers as L
from repro_torch.models import model as M

RWKV, GRIFFIN = "rwkv6-3b", "recurrentgemma-2b"
B, GEN = 2, 4
# the models' prompts: rwkv6-3b's 20 tokens span two 16-token chunks;
# recurrentgemma's are shorter and longer than its 32-slot window
PROMPTS = {RWKV: {"p": 20}, GRIFFIN: {"short": 10, "long": 40}}
GRIFFIN_LAYERS = 5
# rwkv6_chunked cases: name -> (T, chunk)
CHUNKS = {"below": (5, 8), "equal": (8, 8), "ragged": (13, 4)}
# gqa_decode_window: a ring of W slots over more steps than W
RING, RING_STEPS = 4, 7


def _cfg(arch):
    cfg = smoke_config(get_config(arch))
    if arch == GRIFFIN:
        cfg = dataclasses.replace(cfg, n_layers=GRIFFIN_LAYERS)
    return cfg


_REFERENCE = REFERENCE_HEAD + """
import dataclasses
from repro.models import attention as A, griffin, layers as L, rwkv

c = inp["core"]
flat("scan", rwkv.rwkv6_scan(c[0], c[1], c[2], inp["w"], inp["u"],
                             inp["s0"]))
for name, (n, chunk) in {chunks!r}.items():
    flat(f"chunked/{{name}}", rwkv.rwkv6_chunked(
        c[0][:, :n], c[1][:, :n], c[2][:, :n], inp["w"][:, :n], inp["u"],
        inp["s0"], chunk))

ax = jnp.asarray(inp["ax"])
rcfg = smoke_config(get_config("{rwkv}"))
rp = model_run("{rwkv}", rcfg, {rwkv_prompts!r}, {gen})
l0 = jax.tree.map(lambda a: a[0], rp["dec"]["groups"][0])
for mode, x in (("prefill", ax), ("decode", ax[:, :1])):
    flat(f"rwkv/{{mode}}", rwkv.apply_rwkv(l0["mixer"], x, rcfg,
                                           state=inp["rwkv/state"],
                                           x_prev=inp["rwkv/xp"]))
    flat(f"cmix/{{mode}}", L.apply_rwkv_cmix(l0["ffn"], x, inp["rwkv/xp"]))

gcfg = dataclasses.replace(smoke_config(get_config("{griffin}")),
                           n_layers={griffin_layers})
gp = model_run("{griffin}", gcfg, {griffin_prompts!r}, {gen})
g0 = jax.tree.map(lambda a: a[0], gp["dec"]["groups"][0])["mixer"]
for mode, x in (("prefill", ax), ("decode", ax[:, :1])):
    flat(f"griffin/{{mode}}", griffin.apply_griffin(
        g0, x, gcfg, state=(inp["g/h0"], inp["g/conv"])))
    s = x.shape[1]
    flat(f"rglru/{{mode}}", griffin.rglru(
        inp["g/x"][:, :s], inp["g/a"][:, :s], inp["g/i"][:, :s], g0["lam"],
        inp["g/h0"]))
out["block_diag"] = griffin._block_diag(inp["g/x"], g0["w_a"])

att = jax.tree.map(lambda a: a[0], gp["dec"]["groups"][2])["mixer"]
hd, nkv = gcfg.resolved_head_dim, gcfg.n_kv_heads
cache = A.WindowKVCache(jnp.zeros((2, {ring}, nkv, hd)),
                        jnp.zeros((2, {ring}, nkv, hd)),
                        jnp.full(({ring},), -1, jnp.int32))
for i in range({ring_steps}):
    y, cache = A.gqa_decode_window(
        att, ax[:, i:i + 1], gcfg, cache=cache,
        cache_pos=jnp.asarray(i, jnp.int32),
        positions=M.make_positions(gcfg, 2, 1, offset=i))
    out[f"window/{{i}}"] = y
flat("window/cache", cache)
np.savez({out_path!r}, **out)
print("REFERENCE_OK")
"""


def _inputs():
    rng = np.random.default_rng(25)
    f32 = np.float32

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(f32)

    n = max(n for n, _ in CHUNKS.values())
    rcfg, gcfg = _cfg(RWKV), _cfg(GRIFFIN)
    d, kd = rcfg.d_model, rcfg.recurrent.rwkv_head_dim
    lw = gcfg.recurrent.lru_width
    inp = {"core": normal(3, 2, n, 3, 8),            # r, k, v
           "w": np.exp(-np.exp(normal(2, n, 3, 8, scale=0.5) - 1.0)),
           "u": normal(3, 8), "s0": normal(2, 3, 8, 8),
           "ax": normal(2, 8, d),
           "rwkv/state": normal(2, d // kd, kd, kd, scale=0.5),
           "rwkv/xp": normal(2, 1, d),
           "g/h0": normal(2, lw),
           "g/conv": normal(2, gcfg.recurrent.conv_width - 1, lw),
           "g/x": normal(2, 8, lw), "g/a": normal(2, 8, lw),
           "g/i": normal(2, 8, lw)}
    for arch, prompts in PROMPTS.items():
        for name, s in prompts.items():
            inp[f"{arch}/{name}/tokens"] = rng.integers(
                0, 512, (B, s)).astype(np.int32)
            inp[f"{arch}/{name}/forced"] = rng.integers(
                0, 512, (B, GEN)).astype(np.int32)
    return inp


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(inputs, reference outputs), all from one subprocess."""
    d = tmp_path_factory.mktemp("recurrent_ref")
    inp = _inputs()
    np.savez(d / "inp.npz", **inp)
    out = run_with_devices(_REFERENCE.format(
        inp=str(d / "inp.npz"), out_path=str(d / "out.npz"), gen=GEN,
        chunks=CHUNKS, rwkv=RWKV, griffin=GRIFFIN,
        rwkv_prompts=list(PROMPTS[RWKV]),
        griffin_prompts=list(PROMPTS[GRIFFIN]),
        griffin_layers=GRIFFIN_LAYERS, ring=RING, ring_steps=RING_STEPS,
        max_seq=MAX_SEQ), n_devices=1, timeout=600)
    assert "REFERENCE_OK" in out
    return inp, dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def models(ref):
    _, out = ref
    return {arch: (_cfg(arch), params_of(out, arch, _cfg(arch), M))
            for arch in PROMPTS}


# --------------------------------------------------------------------------
# RWKV-6
# --------------------------------------------------------------------------

def _core(inp, n):
    c = t(inp["core"])[:, :, :n]
    return c[0], c[1], c[2], t(inp["w"])[:, :n], t(inp["u"]), t(inp["s0"])


def test_rwkv6_scan_matches_reference(ref):
    inp, out = ref
    n = inp["core"].shape[2]
    o, s = rwkv.rwkv6_scan(*_core(inp, n))
    assert o.shape == (2, n, 3, 8) and s.dtype == torch.float32
    close_all((o, s), tree(out, "scan"))


@pytest.mark.parametrize("case", CHUNKS)
def test_rwkv6_chunked_matches_reference(ref, case):
    inp, out = ref
    n, chunk = CHUNKS[case]
    got = rwkv.rwkv6_chunked(*_core(inp, n), chunk)
    close_all(got, tree(out, f"chunked/{case}"))
    # the chunked form equals the recurrence
    close_all(got, rwkv.rwkv6_scan(*_core(inp, n)))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_apply_rwkv_matches_reference(ref, models, mode):
    """Layer 0's time mix from a non-zero state and carry: 8 tokens in
    prefill (one chunk of 8), 1 in decode."""
    inp, out = ref
    cfg, params = models[RWKV]
    x = t(inp["ax"]) if mode == "prefill" else t(inp["ax"])[:, :1]
    y, (st, xp) = rwkv.apply_rwkv(params.layers[0].mixer, x, cfg,
                                  state=t(inp["rwkv/state"]),
                                  x_prev=t(inp["rwkv/xp"]))
    assert st.dtype == xp.dtype == torch.float32
    close_all((y, (st, xp)), tree(out, f"rwkv/{mode}"))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_apply_rwkv_cmix_matches_reference(ref, models, mode):
    inp, out = ref
    cfg, params = models[RWKV]
    x = t(inp["ax"]) if mode == "prefill" else t(inp["ax"])[:, :1]
    got = L.apply_rwkv_cmix(params.layers[0].ffn, x, t(inp["rwkv/xp"]))
    assert got[1].dtype == torch.float32
    close_all(got, tree(out, f"cmix/{mode}"))


# --------------------------------------------------------------------------
# Griffin
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_rglru_matches_reference(ref, models, mode):
    inp, out = ref
    _, params = models[GRIFFIN]
    s = 8 if mode == "prefill" else 1
    got = griffin.rglru(t(inp["g/x"])[:, :s], t(inp["g/a"])[:, :s],
                        t(inp["g/i"])[:, :s], params.layers[0].mixer["lam"],
                        t(inp["g/h0"]))
    assert got[1].dtype == torch.float32
    close_all(got, tree(out, f"rglru/{mode}"))


def test_linear_scan_is_the_recurrence():
    """The log-depth scan against h_t = a_t h_{t-1} + b_t step by step,
    at lengths around powers of two."""
    gen = torch.Generator().manual_seed(0)
    for n in (1, 2, 3, 7, 8, 9, 33):
        a = torch.rand((2, n, 5), generator=gen)
        b = torch.randn((2, n, 5), generator=gen)
        a_cum, h = griffin._linear_scan(a, b)
        want_h, want_a = [], []
        hh, aa = torch.zeros(2, 5), torch.ones(2, 5)
        for i in range(n):
            hh, aa = a[:, i] * hh + b[:, i], aa * a[:, i]
            want_h.append(hh)
            want_a.append(aa)
        torch.testing.assert_close(h, torch.stack(want_h, 1), **TOL)
        torch.testing.assert_close(a_cum, torch.stack(want_a, 1), **TOL)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_apply_griffin_matches_reference(ref, models, mode):
    """Layer 0's recurrent block from a non-zero ``h0`` and a carried
    conv buffer of 3 inputs."""
    inp, out = ref
    cfg, params = models[GRIFFIN]
    x = t(inp["ax"]) if mode == "prefill" else t(inp["ax"])[:, :1]
    y, (h, conv) = griffin.apply_griffin(
        params.layers[0].mixer, x, cfg,
        state=(t(inp["g/h0"]), t(inp["g/conv"])))
    assert conv.dtype == torch.float32 and conv.shape == inp["g/conv"].shape
    close_all((y, (h, conv)), tree(out, f"griffin/{mode}"))


def test_block_diag_matches_reference(ref, models):
    inp, out = ref
    _, params = models[GRIFFIN]
    close(griffin._block_diag(t(inp["g/x"]), params.layers[0].mixer["w_a"]),
          out["block_diag"])


# --------------------------------------------------------------------------
# the window cache
# --------------------------------------------------------------------------

def test_gqa_decode_window_matches_reference(ref, models):
    """Layer 2's attention over 7 steps of a 4-slot ring, written in
    place: from step 4 on each step overwrites the oldest slot."""
    inp, out = ref
    cfg, params = models[GRIFFIN]
    mixer = params.layers[2].mixer
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    cache = A.WindowKVCache(torch.zeros((2, RING, nkv, hd)),
                            torch.zeros((2, RING, nkv, hd)),
                            torch.full((RING,), -1, dtype=torch.int32))
    ax = t(inp["ax"])
    for i in range(RING_STEPS):
        y, c = A.gqa_decode_window(
            mixer, ax[:, i:i + 1], cfg, cache=cache, cache_pos=i,
            positions=M.make_positions(cfg, 2, 1, offset=i))
        assert all(a is b for a, b in zip(c, cache))
        close(y, out[f"window/{i}"])
    close_all(cache, tree(out, "window/cache"))
    assert cache.pos_slots.tolist() == [4, 5, 6, 3]


@pytest.mark.parametrize("prompt", ["short", "long"])
def test_window_conversion_matches_reference(ref, models, prompt):
    """``state_from_prefill`` puts the prompt's last min(32, S) positions
    at slot ``pos % 32`` of a 32-slot ring (-1 in the empty slots)."""
    inp, out = ref
    cfg, params = models[GRIFFIN]
    s = PROMPTS[GRIFFIN][prompt]
    _, pst = M.prefill(params, cfg,
                       {"tokens": t(inp[f"{GRIFFIN}/{prompt}/tokens"])})
    st = state_from_prefill(cfg, pst, s + GEN)
    close_caches(st.caches, tree(out, f"{GRIFFIN}/{prompt}/padded_caches"),
                 cfg)
    w = cfg.local_window
    want = [-1] * w
    for p in range(max(s - w, 0), s):
        want[p % w] = p
    ring = st.caches[2]["self"]
    assert isinstance(ring, A.WindowKVCache)
    assert ring.pos_slots.tolist() == want and ring.k.shape[1] == w
    torch.testing.assert_close(ring.k[:, s % w if s > w else 0],
                               pst.caches[2]["self"].k[:, max(s - w, 0)])


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(PROMPTS))
def test_count_params_matches_reference(ref, models, arch):
    _, out = ref
    cfg, params = models[arch]
    assert M.count_params(params) == int(out[f"{arch}/count"])
    fresh = M.init_params(torch.Generator().manual_seed(0), cfg,
                          max_seq=MAX_SEQ, device="cpu")
    assert sorted((n, p.shape, p.dtype) for n, p in fresh.named_parameters()) \
        == sorted((n, p.shape, p.dtype) for n, p in params.named_parameters())
    assert [b.kind for b in params.layers] == list(cfg.layer_kinds())


CASES = [(arch, name) for arch, prompts in PROMPTS.items()
         for name in prompts]


@pytest.mark.parametrize("arch,prompt", CASES)
def test_forward_and_prefill_match_reference(ref, models, arch, prompt):
    inp, out = ref
    cfg, params = models[arch]
    key = f"{arch}/{prompt}"
    batch = {"tokens": t(inp[f"{key}/tokens"])}
    logits, caches, aux = M.forward(params, cfg, batch)
    assert caches is None
    close(logits, out[f"{key}/forward"])
    close(aux, out[f"{key}/forward_aux"])        # an f32 zero: no MoE
    last, st = M.prefill(params, cfg, batch)
    close(last, out[f"{key}/prefill"])
    close_caches(st.caches, tree(out, f"{key}/prefill_caches"), cfg)


@pytest.mark.parametrize("arch,prompt", CASES)
def test_teacher_forced_decode_matches_reference(ref, models, arch, prompt):
    inp, out = ref
    cfg, params = models[arch]
    key = f"{arch}/{prompt}"
    s = PROMPTS[arch][prompt]
    _, st = M.prefill(params, cfg, {"tokens": t(inp[f"{key}/tokens"])})
    st = state_from_prefill(cfg, st, s + GEN)
    close_caches(st.caches, tree(out, f"{key}/padded_caches"), cfg)
    forced = t(inp[f"{key}/forced"])
    for i in range(GEN):
        logits, st = M.decode_step(params, cfg, st, forced[:, i:i + 1])
        assert st.pos == s + i + 1
        close(logits, out[f"{key}/decode/{i}"])
    close_caches(st.caches, tree(out, f"{key}/decode_caches"), cfg)
