"""The port's MoE against the reference package.

granite-moe-1b-a400m and moonshot-v1-16b-a3b (a shared expert) at their
smoke configs (f32; 4 experts, top-2):

- ``apply_moe`` (the ``"capacity"`` route) ``y`` and ``aux`` on layer 0's
  weights; on a batch that overflows capacity (B = 4, every token the
  same, so every token goes to the same two experts and 6 of 16 are
  dropped from each); ``_moe_local(impl="ragged")`` (dropless); a zero
  router, whose equal columns tie every expert, so that ``lax.top_k``'s
  lowest-index order picks experts 0 and 1;
- reference fault 8: at a decode's shape (4, 1, D) one row's output
  changes when another row of the batch changes (the capacity drop), in
  both packages alike;
- the model, with the reference's weights carried across by
  ``params_from_reference``: ``count_params``, ``forward`` logits,
  ``prefill`` logits and caches, ``state_from_prefill`` and 4
  teacher-forced ``decode_step``s.

Every JAX output comes from ONE subprocess (an ``.npz``); inputs are
made with numpy from a seed.  Tolerance: ``torch.testing.assert_close(
rtol=1e-4, atol=1e-5)`` on f32 outputs.
"""
import numpy as np
import pytest
import torch
from conftest import run_with_devices
from torch_lm_ref import (MAX_SEQ, REFERENCE_HEAD, TOL, close, close_all,
                          close_caches, params_of, t, tree)

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.kernels.topk import local_topk
from repro_torch.launch.serve import state_from_prefill
from repro_torch.models import model as M
from repro_torch.models import moe

ARCHS = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b")
B, S, GEN = 2, 10, 4
CASES = ("x", "flood")          # apply_moe inputs: random, overflowing

_REFERENCE = REFERENCE_HEAD + """
from repro.models import moe
for arch in {archs!r}:
    cfg = smoke_config(get_config(arch))
    params = model_run(arch, cfg, ["p"], {gen})
    ffn = jax.tree.map(lambda a: a[0], params["dec"]["groups"][0])["ffn"]
    for case in {cases!r}:
        x = jnp.asarray(inp[f"moe/{{case}}"])
        flat(f"{{arch}}/moe/{{case}}", moe.apply_moe(ffn, x, cfg))
        flat(f"{{arch}}/ragged/{{case}}",
             moe._moe_local(ffn, x, cfg, impl="ragged"))
    tied = dict(ffn, router=jnp.zeros_like(ffn["router"]))
    flat(f"{{arch}}/tied", moe.apply_moe(tied, jnp.asarray(inp["moe/x"]),
                                         cfg))
    for case in ("same", "other"):
        flat(f"{{arch}}/batchmates/{{case}}", moe.apply_moe(
            ffn, jnp.asarray(inp[f"moe/dec_{{case}}"]), cfg))
np.savez({out_path!r}, **out)
print("REFERENCE_OK")
"""


def _inputs():
    rng = np.random.default_rng(24)
    f32 = np.float32
    d = smoke_config(get_config(ARCHS[0])).d_model
    one = rng.standard_normal((1, 1, d)).astype(f32)
    same = np.repeat(one, 4, axis=0)            # (4, 1, D), equal rows
    other = same.copy()
    other[0] = -other[0]      # row 0's logits negated: its top-2 moves
    inp = {"moe/x": rng.standard_normal((2, 5, d)).astype(f32),
           "moe/flood": np.repeat(one, 16, axis=1).reshape(4, 4, d),
           "moe/dec_same": same, "moe/dec_other": other}
    for arch in ARCHS:
        inp[f"{arch}/p/tokens"] = rng.integers(0, 512, (B, S)).astype(
            np.int32)
        inp[f"{arch}/p/forced"] = rng.integers(0, 512, (B, GEN)).astype(
            np.int32)
    return inp


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(inputs, reference outputs), all from one subprocess."""
    d = tmp_path_factory.mktemp("moe_ref")
    inp = _inputs()
    np.savez(d / "inp.npz", **inp)
    out = run_with_devices(_REFERENCE.format(
        inp=str(d / "inp.npz"), out_path=str(d / "out.npz"), gen=GEN,
        archs=ARCHS, cases=CASES, max_seq=MAX_SEQ), n_devices=1,
        timeout=600)
    assert "REFERENCE_OK" in out
    return inp, dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def models(ref):
    _, out = ref
    got = {}
    for arch in ARCHS:
        cfg = smoke_config(get_config(arch))
        got[arch] = (cfg, params_of(out, arch, cfg, M))
    return got


def _ffn(models, arch):
    cfg, params = models[arch]
    return cfg, params.layers[0].ffn


# --------------------------------------------------------------------------
# the module
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(ref, models, arch, case):
    inp, out = ref
    cfg, ffn = _ffn(models, arch)
    y, aux = moe.apply_moe(ffn, t(inp[f"moe/{case}"]), cfg)
    assert y.shape == inp[f"moe/{case}"].shape and aux.shape == ()
    close_all((y, aux), tree(out, f"{arch}/moe/{case}"))


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_reference(ref, models, arch):
    """16 equal tokens, top-2 of 4 experts, capacity ceil(16 * 2 / 4 *
    1.25) = 10: each of the two experts drops the last 6 tokens, so the
    first 10 tokens get both experts, the last 6 neither (moonshot: its
    shared expert only), and the dropless route differs there."""
    inp, out = ref
    cfg, ffn = _ffn(models, arch)
    x = t(inp["moe/flood"])
    y, aux = moe.apply_moe(ffn, x, cfg)
    close_all((y, aux), tree(out, f"{arch}/moe/flood"))
    y, ragged = y.reshape(16, -1), moe._moe_local(ffn, x, cfg,
                                                  impl="ragged")[0]
    ragged = ragged.reshape(16, -1)
    torch.testing.assert_close(y[:10], ragged[:10], **TOL)
    torch.testing.assert_close(y[10:], y[10:11].expand(6, -1))
    assert not torch.allclose(y[10], ragged[10], **TOL)
    if not cfg.moe.n_shared_experts:
        assert not y[10:].any()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_route_matches_reference(ref, models, arch, case):
    inp, out = ref
    cfg, ffn = _ffn(models, arch)
    got = moe._moe_local(ffn, t(inp[f"moe/{case}"]), cfg, impl="ragged")
    close_all(got, tree(out, f"{arch}/ragged/{case}"))


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_take_the_lowest_experts(ref, models, arch):
    """A zero router: every probability 1/4, every expert tied; the
    reference's ``lax.top_k`` and the port's ``local_topk`` take experts
    0 and 1 for every token (``torch.topk`` does not promise that)."""
    inp, out = ref
    cfg, ffn = _ffn(models, arch)
    tied = dict(ffn, router=torch.zeros_like(ffn["router"]))
    close_all(moe.apply_moe(tied, t(inp["moe/x"]), cfg),
                tree(out, f"{arch}/tied"))
    vals, idx = local_topk(torch.full((10, 4), 0.25), 2)
    assert (idx == torch.tensor([0, 1], dtype=torch.int32)).all()
    assert (vals == 0.25).all()
    # the tie order decides the output: experts 2 and 3 give another one
    swapped = dict(tied, w_gate=ffn["w_gate"].flip(0),
                   w_up=ffn["w_up"].flip(0), w_down=ffn["w_down"].flip(0))
    assert not torch.allclose(moe.apply_moe(swapped, t(inp["moe/x"]), cfg)[0],
                              t(tree(out, f"{arch}/tied")[0]))


def test_unknown_impl_is_refused(models):
    cfg, ffn = _ffn(models, ARCHS[0])
    with pytest.raises(ValueError, match="unknown MoE impl"):
        moe._moe_local(ffn, torch.zeros((1, 2, cfg.d_model)), cfg,
                       impl="dense")


# --------------------------------------------------------------------------
# reference fault 8: a decoded token depends on its batch-mates
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_row_depends_on_its_batch_mates(ref, models, arch):
    """Four equal decode rows (B = 4, S = 1): capacity ceil(4 * 2 / 4 *
    1.25) = 3, so row 3 is dropped from both of its experts.  Negating
    row 0 moves row 0 to other experts, and row 3, unchanged, is kept:
    its output changes, in the reference and in the port alike."""
    inp, out = ref
    cfg, ffn = _ffn(models, arch)
    got = {}
    for case in ("same", "other"):
        want = tree(out, f"{arch}/batchmates/{case}")
        got[case] = moe.apply_moe(ffn, t(inp[f"moe/dec_{case}"]), cfg)
        close_all(got[case], want)
    np.testing.assert_array_equal(inp["moe/dec_same"][1:],
                                  inp["moe/dec_other"][1:])
    ref_same, ref_other = (tree(out, f"{arch}/batchmates/{c}")[0][3]
                           for c in ("same", "other"))
    assert not np.allclose(ref_same, ref_other, **TOL)
    assert not torch.allclose(got["same"][0][3], got["other"][0][3], **TOL)
    # rows 1 and 2 are kept either way
    torch.testing.assert_close(got["same"][0][1:3], got["other"][0][1:3])


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
    assert sorted((n, p.shape, p.dtype) for n, p in fresh.named_parameters()) \
        == sorted((n, p.shape, p.dtype) for n, p in params.named_parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(ref, models, arch):
    inp, out = ref
    cfg, params = models[arch]
    batch = {"tokens": t(inp[f"{arch}/p/tokens"])}
    logits, caches, aux = M.forward(params, cfg, batch)
    assert caches is None and logits.shape == (B, S, cfg.padded_vocab())
    close(logits, out[f"{arch}/p/forward"])
    assert float(aux.detach()) > 0               # the routers' aux loss
    close(aux, out[f"{arch}/p/forward_aux"])
    last, st = M.prefill(params, cfg, batch)
    close(last, out[f"{arch}/p/prefill"])
    assert st.pos == S
    close_caches(st.caches, tree(out, f"{arch}/p/prefill_caches"), cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(ref, models, arch):
    inp, out = ref
    cfg, params = models[arch]
    _, st = M.prefill(params, cfg, {"tokens": t(inp[f"{arch}/p/tokens"])})
    st = state_from_prefill(cfg, st, S + GEN)
    close_caches(st.caches, tree(out, f"{arch}/p/padded_caches"), cfg)
    forced = t(inp[f"{arch}/p/forced"])
    for i in range(GEN):
        logits, st = M.decode_step(params, cfg, st, forced[:, i:i + 1])
        assert st.pos == S + i + 1
        close(logits, out[f"{arch}/p/decode/{i}"])
    close_caches(st.caches, tree(out, f"{arch}/p/decode_caches"), cfg)
