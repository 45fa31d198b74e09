"""The port's attention variants against the reference package.

MLA (minicpm3-4b), the encoder-decoder with cross attention and learned
positions (whisper-large-v3) and M-RoPE with the vision stub
(qwen2-vl-72b), each at its smoke config (f32):

- modules: ``apply_mrope`` with three distinct position streams and with
  equal ones (then also == ``apply_rope``), ``sinusoidal_embedding``,
  ``mla_attention`` in train / prefill / decode, ``gqa_attention`` with
  ``kv_source`` (train, prefill), in ``"encode"`` mode and under M-RoPE
  (train, prefill, decode), ``cross_decode``, ``embed_tokens`` (vision
  embeddings over part or all of the prompt; learned positions at an
  offset) and ``encode``;
- the model, with the reference's weights (``M.init_params(PRNGKey(0),
  smoke_config(...), max_seq=64)``, jitted) carried across by
  ``params_from_reference``: ``forward`` logits, ``prefill`` logits and
  caches, ``state_from_prefill`` and 4 teacher-forced ``decode_step``s,
  and ``count_params``;
- reference fault 7: the reference's ``state_from_prefill`` pads or
  trims whisper's cross cache (16 encoder frames) to ``s_max``, the
  port's keeps all 16; the port's decode equals the reference's
  ``decode_step`` on a state whose cross caches are the prefill's own,
  and differs from the reference's on the trimmed ones.

Every JAX output comes from ONE subprocess (an ``.npz``); inputs are
made with numpy from a seed.  Tolerance: ``torch.testing.assert_close(
rtol=1e-4, atol=1e-5)`` on f32 outputs.
"""
import numpy as np
import pytest
import torch
from conftest import run_with_devices

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.launch.serve import state_from_prefill
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.rope import (apply_mrope, apply_rope,
                                     sinusoidal_embedding)

ARCHS = ("minicpm3-4b", "whisper-large-v3", "qwen2-vl-72b")
MLA, WHISPER, VL = ARCHS
TOL = dict(rtol=1e-4, atol=1e-5)
# a prompt and steps whose s_max (14) is not whisper's 16 smoke frames
B, S, GEN, MAX_SEQ = 2, 10, 4, 64
# s_max of the reference's state_from_prefill on whisper: trims, pads
CROSS_S_MAX = (14, 20)
N_VIS = 4                       # vision slots of qwen2-vl's forward
SINUS = ((40, 64), (1500, 8))   # (seq_len, d) of sinusoidal_embedding
THETA, SECTIONS = 1e6, (8, 4, 4)

_REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import get_config, smoke_config
from repro.launch.serve import state_from_prefill
from repro.models import attention as A, model as M
from repro.models.rope import apply_mrope, apply_rope, sinusoidal_embedding
inp = dict(np.load({inp!r}))
out = {{}}
S, GEN = {s}, {gen}

def flat(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(f"{{prefix}}/{{k}}", v)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(f"{{prefix}}/{{i}}", v)
    elif tree is not None:
        out[prefix] = np.asarray(tree)

for name in ("distinct", "equal"):
    out[f"mrope/{{name}}"] = apply_mrope(inp["mq"], inp[f"mpos/{{name}}"],
                                         {theta!r}, {sections!r})
out["rope/equal"] = apply_rope(inp["mq"], inp["mpos/equal"][0], {theta!r})
for n, d in {sinus!r}:
    out[f"sinus/{{n}}/{{d}}"] = sinusoidal_embedding(n, d, jnp.float32)

def batch_of(arch, cfg):
    b = {{"tokens": jnp.asarray(inp["tokens"])}}
    if cfg.is_encoder_decoder:
        b["frames"] = jnp.asarray(inp["frames"])
    if cfg.mrope_sections is not None:
        b["vision_embeds"] = jnp.asarray(inp["vis"])
    return b

for arch in {archs!r}:
    cfg = smoke_config(get_config(arch))
    params = jax.jit(M.init_params, static_argnums=1,
                     static_argnames="max_seq")(jax.random.PRNGKey(0), cfg,
                                                max_seq={max_seq})
    flat(f"{{arch}}/params", params)
    out[f"{{arch}}/count"] = np.asarray(M.count_params(params))
    layer0 = jax.tree.map(lambda a: a[0], params["dec"]["groups"][0])
    ax = inp["ax"]
    pos = M.make_positions(cfg, 2, 6)
    if cfg.attn_kind == "mla":
        for mode in ("train", "prefill"):
            flat(f"{{arch}}/mla/{{mode}}", A.mla_attention(
                layer0["mixer"], ax, cfg, positions=pos, mode=mode))
        cache = A.MLACache(inp["mla/ck"], inp["mla/cr"])
        flat(f"{{arch}}/mla/decode", A.mla_attention(
            layer0["mixer"], ax[:, :1], cfg,
            positions=M.make_positions(cfg, 2, 1, offset=5), mode="decode",
            cache=cache, cache_pos=5))
    if cfg.is_encoder_decoder:
        for mode in ("train", "prefill"):
            flat(f"{{arch}}/cross/{{mode}}", A.gqa_attention(
                layer0["cross"], ax, cfg, positions=pos, mode=mode,
                kv_source=inp["enc"]))
        enc0 = jax.tree.map(lambda a: a[0],
                            params["enc"]["stack"]["groups"][0])
        flat(f"{{arch}}/encode_mode", A.gqa_attention(
            enc0["mixer"], ax, cfg, positions=pos, mode="encode"))
        flat(f"{{arch}}/cross_decode", A.cross_decode(
            layer0["cross"], ax[:, :1], cfg,
            cache=A.KVCache(inp["cross/ck"], inp["cross/cv"])))
        out[f"{{arch}}/encode"] = jax.jit(lambda p, f: M.encode(p, cfg, f))(
            params, inp["frames"])
        out[f"{{arch}}/embed_at"] = M.embed_tokens(
            params, cfg, inp["tokens"][:, :3], pos_offset=7)
    if cfg.mrope_sections is not None:
        for mode in ("train", "prefill"):
            flat(f"{{arch}}/mrope_gqa/{{mode}}", A.gqa_attention(
                layer0["mixer"], ax, cfg, positions=inp["apos"], mode=mode))
        cache = A.KVCache(inp["vl/ck"], inp["vl/cv"])
        flat(f"{{arch}}/mrope_gqa/decode", A.gqa_attention(
            layer0["mixer"], ax[:, :1], cfg, positions=inp["apos"][:, :, :1],
            mode="decode", cache=cache, cache_pos=5))
        for name in ("part", "whole"):
            out[f"{{arch}}/embed/{{name}}"] = M.embed_tokens(
                params, cfg, inp["tokens"], vision_embeds=inp[f"vis/{{name}}"])
    batch = batch_of(arch, cfg)
    logits, _, _ = jax.jit(lambda p, b: M.forward(p, cfg, b, mode="train"))(
        params, batch)
    out[f"{{arch}}/forward"] = logits
    last, pst = jax.jit(lambda p, b: M.prefill(p, cfg, b))(params, batch)
    out[f"{{arch}}/prefill"] = last
    flat(f"{{arch}}/prefill_caches", pst.caches)
    st = state_from_prefill(cfg, pst, S + GEN)
    step = jax.jit(lambda p, s, t: M.decode_step(p, cfg, s, t))
    if cfg.is_encoder_decoder:
        for s_max in {cross_s_max!r}:
            bad = state_from_prefill(cfg, pst, s_max)
            flat(f"{{arch}}/cut/{{s_max}}", bad.caches["groups"][0]["cross"])
        lg, _ = step(params, st, jnp.asarray(inp["forced"][:, :1]))
        out[f"{{arch}}/cut_decode"] = lg
        st = state_from_prefill(cfg, pst, S + GEN)
        # the prefill's own cross caches, whole, as the decode state's
        groups = [dict(g, cross=A.KVCache(
            *(a.astype(jnp.float32) for a in pg["cross"])))
            for g, pg in zip(st.caches["groups"], pst.caches["groups"])]
        st = M.DecodeState({{"groups": groups, "rem": st.caches["rem"]}},
                           st.pos)
    flat(f"{{arch}}/padded_caches", st.caches)
    for i in range(GEN):
        lg, st = step(params, st, jnp.asarray(inp["forced"][:, i:i + 1]))
        out[f"{{arch}}/decode/{{i}}"] = lg
    flat(f"{{arch}}/decode_caches", st.caches)
np.savez({out_path!r}, **out)
print("REFERENCE_OK")
"""


def _inputs():
    rng = np.random.default_rng(23)
    f32 = np.float32
    wcfg, vcfg = (smoke_config(get_config(a)) for a in (WHISPER, VL))
    mcfg = smoke_config(get_config(MLA))
    t = rng.integers(0, 500, (2, 7)).astype(np.int32)
    inp = {"mq": rng.standard_normal((2, 7, 3, 32)).astype(f32),
           "mpos/distinct": np.stack([
               t, t // 3, rng.integers(0, 40, (2, 7)).astype(np.int32)]),
           "mpos/equal": np.stack([t, t, t]),
           "ax": rng.standard_normal((2, 6, 128)).astype(f32),
           "apos": np.stack([rng.permutation(50)[:6].reshape(1, 6)
                             .repeat(2, 0) + o for o in (0, 3, 11)])
           .astype(np.int32),
           "mla/ck": rng.standard_normal(
               (2, 8, mcfg.mla.kv_lora_rank)).astype(f32),
           "mla/cr": rng.standard_normal(
               (2, 8, mcfg.mla.qk_rope_dim)).astype(f32),
           "enc": rng.standard_normal((2, 9, 128)).astype(f32),
           "tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
           "forced": rng.integers(0, 512, (B, GEN)).astype(np.int32),
           "frames": rng.standard_normal(
               (B, wcfg.encoder_seq, 128)).astype(f32),
           "vis": rng.standard_normal((B, N_VIS, 128)).astype(f32),
           "vis/part": rng.standard_normal((B, 3, 128)).astype(f32),
           "vis/whole": rng.standard_normal((B, S + 2, 128)).astype(f32)}
    shape = (2, 9, wcfg.n_kv_heads, wcfg.resolved_head_dim)
    inp["cross/ck"] = rng.standard_normal(shape).astype(f32)
    inp["cross/cv"] = rng.standard_normal(shape).astype(f32)
    shape = (2, 8, vcfg.n_kv_heads, vcfg.resolved_head_dim)
    inp["vl/ck"] = rng.standard_normal(shape).astype(f32)
    inp["vl/cv"] = rng.standard_normal(shape).astype(f32)
    return inp


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
    """(inputs, reference outputs), all from one subprocess."""
    d = tmp_path_factory.mktemp("variants_ref")
    inp = _inputs()
    np.savez(d / "inp.npz", **inp)
    out = run_with_devices(_REFERENCE.format(
        inp=str(d / "inp.npz"), out_path=str(d / "out.npz"), s=S, gen=GEN,
        theta=THETA, sections=SECTIONS, sinus=SINUS, archs=ARCHS,
        max_seq=MAX_SEQ, cross_s_max=CROSS_S_MAX), n_devices=1,
        timeout=600)
    assert "REFERENCE_OK" in out
    return inp, dict(np.load(d / "out.npz"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    torch.testing.assert_close(got, _t(want), **TOL)


@pytest.fixture(scope="module")
def models(ref):
    _, out = ref
    got = {}
    for arch in ARCHS:
        cfg = smoke_config(get_config(arch))
        tree = _tree(out, f"{arch}/params")
        tree["dec"].setdefault("rem", [])      # an empty list saves no key
        got[arch] = (cfg, M.params_from_reference(tree, cfg, device="cpu"))
    return got


def _batch(inp, cfg):
    batch = {"tokens": _t(inp["tokens"])}
    if cfg.is_encoder_decoder:
        batch["frames"] = _t(inp["frames"])
    if cfg.mrope_sections is not None:
        batch["vision_embeds"] = _t(inp["vis"])
    return batch


def _close_caches(caches, want):
    """The port's per-layer cache dicts against the reference's, stacked
    over its scan groups (one slot, no remainder at the smoke size)."""
    want = want["groups"][0]
    for i, layer in enumerate(caches):
        assert set(layer) == set(want)
        for key, c in layer.items():
            assert len(c) == len(want[key])
            for j, a in enumerate(c):
                _close(a, want[key][j][i])


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("streams", ["distinct", "equal"])
def test_apply_mrope_matches_reference(ref, streams):
    inp, out = ref
    got = apply_mrope(_t(inp["mq"]), _t(inp[f"mpos/{streams}"]), THETA,
                      SECTIONS)
    _close(got, out[f"mrope/{streams}"])
    rope = apply_rope(_t(inp["mq"]), _t(inp[f"mpos/{streams}"][0]), THETA)
    _close(rope, out["rope/equal"])
    if streams == "equal":              # text positions: M-RoPE == RoPE
        torch.testing.assert_close(got, rope, rtol=0, atol=0)
    else:                               # the sections pick their streams
        assert not torch.allclose(got, rope, **TOL)


def test_apply_mrope_refuses_sections_of_another_width(ref):
    inp, _ = ref
    with pytest.raises(ValueError, match="do not sum"):
        apply_mrope(_t(inp["mq"]), _t(inp["mpos/equal"]), THETA, (8, 4, 8))


@pytest.mark.parametrize("n,d", SINUS)
def test_sinusoidal_embedding_matches_reference(ref, n, d):
    _, out = ref
    got = sinusoidal_embedding(n, d, torch.float32)
    assert got.shape == (n, d)
    _close(got, out[f"sinus/{n}/{d}"])


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mla_attention_matches_reference(ref, models, mode):
    """Layer 0's MLA alone: the expanded form, causal over 6 positions
    (and the prompt's latent cache in prefill), or the absorbed form:
    one token written at position 5 of a random 8-slot cache (in
    place) and attending to slots 0..5."""
    inp, out = ref
    cfg, params = models[MLA]
    mixer = params.layers[0].mixer
    ax = _t(inp["ax"])
    want = _tree(out, f"{MLA}/mla/{mode}")
    if mode == "decode":
        cache = A.MLACache(_t(inp["mla/ck"]).clone(),
                           _t(inp["mla/cr"]).clone())
        y, c = A.mla_attention(
            mixer, ax[:, :1], cfg, positions=M.make_positions(
                cfg, 2, 1, offset=5), mode="decode", cache=cache,
            cache_pos=5)
        assert c.c_kv is cache.c_kv and c.k_rope is cache.k_rope
    else:
        y, c = A.mla_attention(mixer, ax, cfg,
                               positions=M.make_positions(cfg, 2, 6),
                               mode=mode)
    _close(y, want[0])
    if mode == "train":
        assert c is None and len(want) == 1
    else:
        _close(c.c_kv, want[1][0])
        _close(c.k_rope, want[1][1])


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_cross_attention_matches_reference(ref, models, mode):
    """Layer 0's cross attention: 6 queries over 9 encoder frames, no
    mask, no rotation; the encoder's KVCache in both modes."""
    inp, out = ref
    cfg, params = models[WHISPER]
    want = _tree(out, f"{WHISPER}/cross/{mode}")
    y, c = A.gqa_attention(params.layers[0].cross, _t(inp["ax"]), cfg,
                           positions=M.make_positions(cfg, 2, 6), mode=mode,
                           kv_source=_t(inp["enc"]))
    _close(y, want[0])
    assert c.k.shape == (2, 9, cfg.n_kv_heads, cfg.resolved_head_dim)
    _close(c.k, want[1][0])
    _close(c.v, want[1][1])


def test_encode_mode_attention_matches_reference(ref, models):
    inp, out = ref
    cfg, params = models[WHISPER]
    y, c = A.gqa_attention(params.enc.layers[0].mixer, _t(inp["ax"]), cfg,
                           positions=M.make_positions(cfg, 2, 6),
                           mode="encode")
    assert c is None
    _close(y, _tree(out, f"{WHISPER}/encode_mode")[0])


def test_cross_decode_matches_reference(ref, models):
    inp, out = ref
    cfg, params = models[WHISPER]
    cache = A.KVCache(_t(inp["cross/ck"]), _t(inp["cross/cv"]))
    y, c = A.cross_decode(params.layers[0].cross, _t(inp["ax"][:, :1]), cfg,
                          cache=cache)
    assert c is cache
    _close(y, _tree(out, f"{WHISPER}/cross_decode")[0])


def test_encode_matches_reference(ref, models):
    inp, out = ref
    cfg, params = models[WHISPER]
    got = M.encode(params, cfg, _t(inp["frames"]))
    assert got.shape == (B, cfg.encoder_seq, cfg.d_model)
    _close(got, out[f"{WHISPER}/encode"])


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mrope_gqa_attention_matches_reference(ref, models, mode):
    """qwen2-vl's layer 0 under three distinct position streams (the
    serve path's text positions cannot tell M-RoPE from RoPE)."""
    inp, out = ref
    cfg, params = models[VL]
    mixer = params.layers[0].mixer
    ax, apos = _t(inp["ax"]), _t(inp["apos"])
    want = _tree(out, f"{VL}/mrope_gqa/{mode}")
    if mode == "decode":
        cache = A.KVCache(_t(inp["vl/ck"]).clone(), _t(inp["vl/cv"]).clone())
        y, c = A.gqa_attention(mixer, ax[:, :1], cfg,
                               positions=apos[:, :, :1], mode="decode",
                               cache=cache, cache_pos=5)
    else:
        y, c = A.gqa_attention(mixer, ax, cfg, positions=apos, mode=mode)
    _close(y, want[0])
    if mode == "train":
        assert c is None
    else:
        _close(c.k, want[1][0])
        _close(c.v, want[1][1])


@pytest.mark.parametrize("n_vis", ["part", "whole"])
def test_vision_embeds_match_reference(ref, models, n_vis):
    """3 vision slots over a 10-token prompt, or 12 over all of it (the
    tokens then unused)."""
    inp, out = ref
    cfg, params = models[VL]
    got = M.embed_tokens(params, cfg, _t(inp["tokens"]),
                         vision_embeds=_t(inp[f"vis/{n_vis}"]))
    _close(got, out[f"{VL}/embed/{n_vis}"])


def test_learned_positions_at_an_offset_match_reference(ref, models):
    inp, out = ref
    cfg, params = models[WHISPER]
    got = M.embed_tokens(params, cfg, _t(inp["tokens"][:, :3]),
                         pos_offset=7)
    _close(got, out[f"{WHISPER}/embed_at"])
    with pytest.raises(IndexError, match="position table of 64"):
        M.embed_tokens(params, cfg, _t(inp["tokens"][:, :3]),
                       pos_offset=MAX_SEQ - 2)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_reference(ref, models, arch):
    _, out = ref
    cfg, params = models[arch]
    assert M.count_params(params) == int(out[f"{arch}/count"])
    fresh = M.init_params(torch.Generator().manual_seed(0), cfg,
                          max_seq=MAX_SEQ, device="cpu")
    assert M.count_params(fresh) == M.count_params(params)
    assert sorted((n, p.shape, p.dtype) for n, p in fresh.named_parameters()) \
        == sorted((n, p.shape, p.dtype) for n, p in params.named_parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(ref, models, arch):
    inp, out = ref
    cfg, params = models[arch]
    logits, caches, aux = M.forward(params, cfg, _batch(inp, cfg))
    assert caches is None
    # no MoE: the auxiliary loss is an f32 zero, as the reference's
    assert aux.dtype == torch.float32 and aux.shape == () and float(aux) == 0
    assert logits.shape == (B, S, cfg.padded_vocab())
    _close(logits, out[f"{arch}/forward"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_reference(ref, models, arch):
    inp, out = ref
    cfg, params = models[arch]
    last, st = M.prefill(params, cfg, _batch(inp, cfg))
    _close(last, out[f"{arch}/prefill"])
    assert st.pos == S
    _close_caches(st.caches, _tree(out, f"{arch}/prefill_caches"))


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(ref, models, arch):
    """Prefill, ``state_from_prefill`` (f32 caches padded to S + GEN
    with zeros; whisper's cross caches whole, and the reference's state
    given the same) and 4 decode steps on given tokens."""
    inp, out = ref
    cfg, params = models[arch]
    _, st = M.prefill(params, cfg, _batch(inp, cfg))
    st = state_from_prefill(cfg, st, S + GEN)
    for layer in st.caches:
        for a in layer["self"]:
            assert a.dtype == torch.float32 and a.shape[1] == S + GEN
            assert not a[:, S:].any()
    _close_caches(st.caches, _tree(out, f"{arch}/padded_caches"))
    forced = _t(inp["forced"])
    for i in range(GEN):
        logits, st = M.decode_step(params, cfg, st, forced[:, i:i + 1])
        assert st.pos == S + i + 1
        _close(logits, out[f"{arch}/decode/{i}"])
    _close_caches(st.caches, _tree(out, f"{arch}/decode_caches"))


# --------------------------------------------------------------------------
# reference fault 7: the cross cache through state_from_prefill
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s_max", CROSS_S_MAX)
def test_reference_cuts_the_cross_cache_to_s_max(ref, s_max):
    """The reference's ``state_from_prefill`` trims whisper's 16 frames
    to s_max 14, or pads them with zero frames to 20: its decode then
    attends to other keys than the encoder's."""
    _, out = ref
    cfg = smoke_config(get_config(WHISPER))
    k, v = _tree(out, f"{WHISPER}/cut/{s_max}")
    want = _tree(out, f"{WHISPER}/prefill_caches")["groups"][0]["cross"]
    assert cfg.encoder_seq == want[0].shape[2] == 16
    assert k.shape == (cfg.n_layers, B, s_max, cfg.n_kv_heads,
                       cfg.resolved_head_dim)
    keep = min(s_max, cfg.encoder_seq)
    np.testing.assert_array_equal(k[:, :, :keep], want[0][:, :, :keep])
    np.testing.assert_array_equal(v[:, :, :keep], want[1][:, :, :keep])
    assert not k[:, :, keep:].any() and not v[:, :, keep:].any()


@pytest.mark.parametrize("s_max", CROSS_S_MAX)
def test_port_keeps_the_whole_cross_cache(ref, models, s_max):
    inp, out = ref
    cfg, params = models[WHISPER]
    _, pst = M.prefill(params, cfg, _batch(inp, cfg))
    st = state_from_prefill(cfg, pst, s_max)
    want = _tree(out, f"{WHISPER}/prefill_caches")["groups"][0]["cross"]
    for i, layer in enumerate(st.caches):
        assert layer["self"].k.shape[1] == s_max
        assert layer["cross"].k.shape == (B, cfg.encoder_seq,
                                          cfg.n_kv_heads,
                                          cfg.resolved_head_dim)
        assert layer["cross"].k.dtype == torch.float32
        _close(layer["cross"].k, want[0][i])
        _close(layer["cross"].v, want[1][i])


def test_port_decode_differs_from_the_reference_on_a_cut_cross_cache(
        ref, models):
    """Step 0 on the reference's trimmed cross caches gives other logits
    than on whole ones (which the port matches, above)."""
    inp, out = ref
    cfg, params = models[WHISPER]
    _, st = M.prefill(params, cfg, _batch(inp, cfg))
    st = state_from_prefill(cfg, st, S + GEN)
    logits, _ = M.decode_step(params, cfg, st, _t(inp["forced"][:, :1]))
    _close(logits, out[f"{WHISPER}/decode/0"])
    assert not torch.allclose(logits, _t(out[f"{WHISPER}/cut_decode"]),
                              **TOL)
