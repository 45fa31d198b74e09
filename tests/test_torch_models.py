"""The port's dense GQA model stack against the reference package.

For the smoke configs (f32) of the three dense archs the port runs
(qwen2-0.5b: GQA with QKV bias, tied; qwen1.5-0.5b: MHA, tied;
phi3-medium-14b: GQA, untied, no bias): the layers (``apply_norm`` rms /
ln, ``apply_rope``, ``apply_ffn`` swiglu / gelu), ``flash_attention``
(causal; a window; ``kv_valid_len`` with ``q_offset``; GQA at g = 1, 2,
4; blocks that do not divide the sequence; fully masked blocks),
``_plain_decode_attn``, and the model: ``forward`` logits, ``prefill``
logits and caches, ``state_from_prefill`` and 4 teacher-forced
``decode_step``s, with the reference's weights
(``M.init_params(PRNGKey(0), smoke_config(...))``, jitted) carried across by
``params_from_reference``; ``count_params`` equals the reference's.

Every JAX output comes from ONE subprocess (an ``.npz``); inputs are
made with numpy from a seed.  Tolerance: ``torch.testing.assert_close(
rtol=1e-4, atol=1e-5)`` on f32 outputs (the two packages sum in other
orders and use other ``exp`` / ``sin`` / ``pow``; the largest error
seen here is printed by a failing assertion).  The attention variants
(MLA, the encoder-decoder, M-RoPE) are held to the reference in
tests/test_torch_variants.py, MoE in tests/test_torch_moe.py, RWKV,
Griffin and the sliding-window cache in tests/test_torch_recurrent.py.
"""
import numpy as np
import pytest
import torch
from conftest import run_with_devices

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.launch.serve import state_from_prefill
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.rope import apply_rope

ARCHS = ("qwen2-0.5b", "qwen1.5-0.5b", "phi3-medium-14b")
TOL = dict(rtol=1e-4, atol=1e-5)
B, S, GEN = 2, 12, 4
# flash_attention cases: name -> (B, Sq, Sk, Hq, Hkv, D, kwargs)
FLASH = {
    "causal": (2, 16, 16, 4, 2, 16, dict(causal=True, q_block=8,
                                          kv_block=8)),
    "ragged-blocks": (2, 13, 13, 4, 2, 16, dict(causal=True, q_block=5,
                                                 kv_block=4)),
    "window": (1, 20, 20, 4, 1, 8, dict(causal=True, window=6, q_block=4,
                                        kv_block=4)),
    "kv-valid-offset": (2, 3, 16, 8, 2, 16, dict(causal=True, q_offset=9,
                                                 kv_valid_len=12,
                                                 q_block=2, kv_block=4)),
    "mha-noncausal": (1, 9, 11, 2, 2, 16, dict(causal=False, q_block=4,
                                               kv_block=3)),
    "masked-tail": (1, 4, 16, 4, 4, 8, dict(causal=False, kv_valid_len=5,
                                            q_block=4, kv_block=4)),
}

_REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import get_config, smoke_config
from repro.launch.serve import state_from_prefill
from repro.models import attention as A, layers as L, model as M
from repro.models.rope import apply_rope
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

x = inp["x"]
out["norm/rms"] = L.apply_norm({{"scale": inp["scale"]}}, x, "rms")
out["norm/ln"] = L.apply_norm({{"scale": inp["scale"], "bias": inp["bias"]}},
                              x, "ln")
for theta in (1e4, 1e6):
    out[f"rope/{{theta:g}}"] = apply_rope(inp["rq"], inp["rpos"], theta)
for act in ("swiglu", "gelu"):
    p = {{k[len(act) + 1:]: v for k, v in inp.items()
         if k.startswith(act + "/")}}
    out[f"ffn/{{act}}"] = L.apply_ffn(p, x, act)
for name, kw in {flash!r}.items():
    out[f"flash/{{name}}"] = A.flash_attention(
        inp[f"{{name}}/q"], inp[f"{{name}}/k"], inp[f"{{name}}/v"], **kw)
for name in ("batch", "shared"):
    out[f"plain/{{name}}"] = A._plain_decode_attn(
        inp["pq"], inp["pk"], inp["pv"], inp[f"pmask/{{name}}"])
for arch in {archs!r}:
    cfg = smoke_config(get_config(arch))
    params = jax.jit(M.init_params, static_argnums=1,
                     static_argnames="max_seq")(jax.random.PRNGKey(0), cfg,
                                                max_seq=64)
    flat(f"{{arch}}/params", params)
    mp = jax.tree.map(lambda a: a[0], params["dec"]["groups"][0]["mixer"])
    ax = inp["ax"]
    pos = M.make_positions(cfg, ax.shape[0], ax.shape[1])
    for mode in ("train", "prefill"):
        flat(f"{{arch}}/gqa/{{mode}}", A.gqa_attention(
            mp, ax, cfg, positions=pos, mode=mode))
    cache = A.KVCache(inp[f"{{arch}}/ck"], inp[f"{{arch}}/cv"])
    flat(f"{{arch}}/gqa/decode", A.gqa_attention(
        mp, ax[:, :1], cfg, positions=M.make_positions(cfg, 2, 1, offset=5),
        mode="decode", cache=cache, cache_pos=5))
    out[f"{{arch}}/count"] = np.asarray(M.count_params(params))
    toks = jnp.asarray(inp["tokens"])
    logits, _, _ = jax.jit(lambda p, t: M.forward(
        p, cfg, {{"tokens": t}}, mode="train"))(params, toks)
    out[f"{{arch}}/forward"] = logits
    last, st = jax.jit(lambda p, t: M.prefill(p, cfg, {{"tokens": t}}))(
        params, toks)
    out[f"{{arch}}/prefill"] = last
    flat(f"{{arch}}/prefill_caches", st.caches)
    st = state_from_prefill(cfg, st, {s} + {gen})
    flat(f"{{arch}}/padded_caches", st.caches)
    step = jax.jit(lambda p, s, t: M.decode_step(p, cfg, s, t))
    for i in range({gen}):
        lg, st = step(params, st, jnp.asarray(inp["forced"][:, i:i + 1]))
        out[f"{{arch}}/decode/{{i}}"] = lg
    flat(f"{{arch}}/decode_caches", st.caches)
np.savez({out_path!r}, **out)
print("REFERENCE_OK")
"""


def _inputs():
    rng = np.random.default_rng(21)
    f32 = np.float32
    inp = {"x": rng.standard_normal((2, 5, 32)).astype(f32) * 3 + 1,
           "scale": rng.standard_normal(32).astype(f32),
           "bias": rng.standard_normal(32).astype(f32),
           "rq": rng.standard_normal((2, 7, 3, 16)).astype(f32),
           "rpos": rng.integers(0, 500, (2, 7)).astype(np.int32),
           "pq": rng.standard_normal((2, 1, 4, 16)).astype(f32),
           "pk": rng.standard_normal((2, 10, 2, 16)).astype(f32),
           "pv": rng.standard_normal((2, 10, 2, 16)).astype(f32),
           "pmask/batch": rng.random((2, 1, 1, 10)) < 0.6,
           "pmask/shared": (np.arange(10) <= 6)[None, None, None],
           "tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
           "forced": rng.integers(0, 512, (B, GEN)).astype(np.int32),
           "ax": rng.standard_normal((2, 6, 128)).astype(f32)}
    for arch in ARCHS:
        cfg = smoke_config(get_config(arch))
        shape = (2, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
        inp[f"{arch}/ck"] = rng.standard_normal(shape).astype(f32)
        inp[f"{arch}/cv"] = rng.standard_normal(shape).astype(f32)
    inp["pmask/batch"][:, ..., 0] = True
    for act, shapes in (("swiglu", {"w_gate": (32, 48), "w_up": (32, 48),
                                    "w_down": (48, 32)}),
                        ("gelu", {"w_up": (32, 48), "b_up": (48,),
                                  "w_down": (48, 32), "b_down": (32,)})):
        for k, shp in shapes.items():
            inp[f"{act}/{k}"] = (rng.standard_normal(shp) * 0.2).astype(f32)
    for name, (b, sq, sk, hq, hkv, d, _) in FLASH.items():
        inp[f"{name}/q"] = rng.standard_normal((b, sq, hq, d)).astype(f32)
        inp[f"{name}/k"] = rng.standard_normal((b, sk, hkv, d)).astype(f32)
        inp[f"{name}/v"] = rng.standard_normal((b, sk, hkv, d)).astype(f32)
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
    d = tmp_path_factory.mktemp("models_ref")
    inp = _inputs()
    np.savez(d / "inp.npz", **inp)
    out = run_with_devices(_REFERENCE.format(
        inp=str(d / "inp.npz"), out_path=str(d / "out.npz"),
        flash={k: v[-1] for k, v in FLASH.items()}, archs=ARCHS, s=S,
        gen=GEN), n_devices=1, timeout=600)
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


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_apply_norm(ref, kind):
    inp, out = ref
    p = {"scale": _t(inp["scale"]), "bias": _t(inp["bias"])}
    _close(L.apply_norm(p, _t(inp["x"]), kind), out[f"norm/{kind}"])


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(ref, theta):
    inp, out = ref
    _close(apply_rope(_t(inp["rq"]), _t(inp["rpos"]), theta),
           out[f"rope/{theta:g}"])


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_ffn(ref, act):
    inp, out = ref
    p = {k[len(act) + 1:]: _t(v) for k, v in inp.items()
         if k.startswith(act + "/")}
    _close(L.apply_ffn(p, _t(inp["x"]), act), out[f"ffn/{act}"])


@pytest.mark.parametrize("name", list(FLASH))
def test_flash_attention(ref, name):
    inp, out = ref
    got = A.flash_attention(_t(inp[f"{name}/q"]), _t(inp[f"{name}/k"]),
                            _t(inp[f"{name}/v"]), **FLASH[name][-1])
    assert got.dtype == torch.float32
    _close(got, out[f"flash/{name}"])


@pytest.mark.parametrize("mask", ["batch", "shared"])
def test_plain_decode_attn(ref, mask):
    inp, out = ref
    got = A._plain_decode_attn(_t(inp["pq"]), _t(inp["pk"]), _t(inp["pv"]),
                               _t(inp[f"pmask/{mask}"]))
    _close(got, out[f"plain/{mask}"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_gqa_attention_matches_reference(ref, models, arch, mode):
    """Layer 0's attention alone: causal over 6 positions (and the
    prompt's cache in prefill), or one token written at position 5 of a
    random 8-slot cache (in place) and attending to slots 0..5."""
    inp, out = ref
    cfg, params = models[arch]
    mixer = params.layers[0].mixer
    ax = _t(inp["ax"])
    want = _tree(out, f"{arch}/gqa/{mode}")
    if mode == "decode":
        cache = A.KVCache(_t(inp[f"{arch}/ck"]).clone(),
                          _t(inp[f"{arch}/cv"]).clone())
        y, c = A.gqa_attention(
            mixer, ax[:, :1], cfg, positions=M.make_positions(
                cfg, 2, 1, offset=5), mode="decode", cache=cache,
            cache_pos=5)
        assert c.k is cache.k and c.v is cache.v
    else:
        y, c = A.gqa_attention(mixer, ax, cfg,
                               positions=M.make_positions(cfg, 2, 6),
                               mode=mode)
    _close(y, want[0])
    if mode == "train":
        assert c is None and len(want) == 1
    else:
        _close(c.k, want[1][0])
        _close(c.v, want[1][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_reference(ref, models, arch):
    _, out = ref
    cfg, params = models[arch]
    assert M.count_params(params) == int(out[f"{arch}/count"])
    fresh = M.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    assert M.count_params(fresh) == M.count_params(params)
    assert sorted((n, p.shape, p.dtype) for n, p in fresh.named_parameters()) \
        == sorted((n, p.shape, p.dtype) for n, p in params.named_parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(ref, models, arch):
    inp, out = ref
    cfg, params = models[arch]
    logits, caches, aux = M.forward(params, cfg, {"tokens": _t(inp["tokens"])})
    assert caches is None
    # no MoE: the auxiliary loss is an f32 zero, as the reference's
    assert aux.dtype == torch.float32 and aux.shape == () and float(aux) == 0
    assert logits.shape == (B, S, cfg.padded_vocab())
    _close(logits, out[f"{arch}/forward"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_reference(ref, models, arch):
    inp, out = ref
    cfg, params = models[arch]
    last, st = M.prefill(params, cfg, {"tokens": _t(inp["tokens"])})
    _close(last, out[f"{arch}/prefill"])
    assert st.pos == S
    # the reference stacks the layers' caches over its scan groups
    want = _tree(out, f"{arch}/prefill_caches")["groups"][0]["self"]
    for i, c in enumerate(st.caches):
        _close(c["self"].k, want[0][i])
        _close(c["self"].v, want[1][i])


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(ref, models, arch):
    """Prefill, ``state_from_prefill`` (f32 caches padded to S + GEN
    with zeros) and 4 decode steps on given tokens."""
    inp, out = ref
    cfg, params = models[arch]
    _, st = M.prefill(params, cfg, {"tokens": _t(inp["tokens"])})
    st = state_from_prefill(cfg, st, S + GEN)
    want = _tree(out, f"{arch}/padded_caches")["groups"][0]["self"]
    for i, c in enumerate(st.caches):
        assert c["self"].k.dtype == torch.float32
        assert c["self"].k.shape == (B, S + GEN, cfg.n_kv_heads,
                                     cfg.resolved_head_dim)
        assert not c["self"].k[:, S:].any() and not c["self"].v[:, S:].any()
        _close(c["self"].k, want[0][i])
        _close(c["self"].v, want[1][i])
    forced = _t(inp["forced"])
    for i in range(GEN):
        logits, st = M.decode_step(params, cfg, st, forced[:, i:i + 1])
        assert st.pos == S + i + 1
        _close(logits, out[f"{arch}/decode/{i}"])
    want = _tree(out, f"{arch}/decode_caches")["groups"][0]["self"]
    for i, c in enumerate(st.caches):
        _close(c["self"].k, want[0][i])
        _close(c["self"].v, want[1][i])
