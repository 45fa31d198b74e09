"""The port's training path against the reference package.

On the smoke configs of all ten archs (f32; recurrentgemma-2b at
``n_layers=5``, so that it has an attention layer and a remainder;
rwkv6-3b at 1 layer, see ``_cfg``), with the reference's weights carried
across by ``params_from_reference``:

- ``loss_fn``'s loss, ``ce``, ``aux`` and ``n_tok`` and the gradient of
  every parameter against ``jax.value_and_grad(repro.models.model.
  loss_fn)``, on a batch with some ``-1`` labels (loss rtol 1e-5;
  gradients rtol 1e-4, atol 1e-5);
- MoE's gradients (the FFN's and the input's) on a batch that
  overflows capacity, so that dropped pairs are compared;
- the top-k with a gradient: its forward bit-equal to ``local_topk``,
  its backward the scatter of the values' gradient (``index_offset``
  non-zero too) and ``lax.top_k``'s VJP bit for bit, f32 and bf16 (a
  bf16 gradient), the indices without one;
- remat ``none``, ``full`` and ``dots`` give equal losses and gradients,
  exactly on the CPU, and the recompute runs each router again;
- ``make_train_step`` with 2 microbatches against the reference's scan
  accumulation (the loss, the global norm, the rate and the first
  moment, which is the accumulated gradient times 0.1);
- three train steps' losses against the reference's ``make_train_step``
  (rtol 1e-4);
- ``adamw_update`` on identical inputs (the reference's weights and
  gradients fed to both), two steps, with reference fault 9's decay rule
  (``optim.adamw.decayed``).

Every JAX output comes from ONE subprocess (an ``.npz``); inputs are
made with numpy from a seed.
"""
import dataclasses

import numpy as np
import pytest
import torch
from conftest import run_with_devices
from torch_lm_ref import (MAX_SEQ, REFERENCE_HEAD, params_of, ref_leaf,
                          ref_value, t)

from repro_torch.configs.base import get_config, list_archs, smoke_config
from repro_torch.data.pipeline import SyntheticLM, extra_model_inputs
from repro_torch.kernels.topk import local_topk, topk_with_grad
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     decayed)
from repro_torch.runtime.steps import make_train_step

ARCHS = tuple(list_archs())
MOE_ARCHS = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b")
OPT_ARCHS = ("qwen2-0.5b", "recurrentgemma-2b")
STEP_ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m")
MB_ARCH = "granite-moe-1b-a400m"
B, S, N_VIS, STEPS = 2, 16, 4, 3
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
OPT_TOL = dict(rtol=1e-5, atol=1e-6)
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
TOPK_K = 5


def _cfg(arch):
    cfg = smoke_config(get_config(arch))
    if arch == "recurrentgemma-2b":      # its smoke config has no attention
        cfg = dataclasses.replace(cfg, n_layers=5)
    if arch == "rwkv6-3b":
        # at the smoke config's 2 layers neither package's f32 gradient
        # of the embedding is within GRAD_TOL of the exact one (the port
        # run in f64), the same in the plain recurrence: the model's f32
        # noise floor; at 1 layer both are
        cfg = dataclasses.replace(cfg, n_layers=1)
    return cfg


_REFERENCE = REFERENCE_HEAD + """
import dataclasses
from jax import lax
from repro import jaxcompat
from repro.launch.mesh import make_host_mesh
from repro.models import moe
from repro.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro.runtime.steps import make_train_step

def cfg_of(arch):
    cfg = smoke_config(get_config(arch))
    if arch == "recurrentgemma-2b":
        cfg = dataclasses.replace(cfg, n_layers=5)
    if arch == "rwkv6-3b":
        cfg = dataclasses.replace(cfg, n_layers=1)
    return cfg

def batch_of(prefix):
    n = len(prefix) + 1
    return {{k[n:]: jnp.asarray(v) for k, v in inp.items()
            if k.startswith(prefix + "/")}}

init = jax.jit(M.init_params, static_argnums=1, static_argnames="max_seq")
params, grads = {{}}, {{}}
for arch in {archs!r}:
    cfg = cfg_of(arch)
    params[arch] = init(jax.random.PRNGKey(0), cfg, max_seq={max_seq})
    flat(f"{{arch}}/params", params[arch])
    vg = jax.jit(jax.value_and_grad(lambda p, b: M.loss_fn(p, cfg, b),
                                    has_aux=True))
    (loss, aux), grads[arch] = vg(params[arch], batch_of(f"{{arch}}/batch"))
    out[f"{{arch}}/loss"] = loss
    flat(f"{{arch}}/aux", aux)
    flat(f"{{arch}}/grads", grads[arch])

# MoE: the gradients of <y, r> + aux on a batch overflowing capacity
for arch in {moe_archs!r}:
    cfg = cfg_of(arch)
    ffn = jax.tree.map(lambda a: a[0], params[arch]["dec"]["groups"][0])["ffn"]
    r = jnp.asarray(inp["moe/r"])
    def obj(ffn, x):
        y, aux = moe.apply_moe(ffn, x, cfg)
        return jnp.sum(y * r) + aux
    g_ffn, g_x = jax.jit(jax.grad(obj, argnums=(0, 1)))(
        ffn, jnp.asarray(inp["moe/flood"]))
    flat(f"{{arch}}/moe_grads/ffn", g_ffn)
    out[f"{{arch}}/moe_grads/x"] = g_x

# lax.top_k's VJP, f32 and bf16
for dt in ("float32", "bfloat16"):
    s = jnp.asarray(inp["topk/scores"]).astype(dt)
    _, vjp = jax.vjp(lambda s: lax.top_k(s, {k})[0], s)
    (g,) = vjp(jnp.asarray(inp["topk/g"]).astype(dt))
    out[f"topk/vjp/{{dt}}"] = np.asarray(g.astype(jnp.float32))

# adamw_update on identical inputs, two steps with the same gradients
ocfg = AdamWConfig(**{opt!r})
upd = jax.jit(lambda g, s, p: adamw_update(g, s, p, ocfg))
for arch in {opt_archs!r}:
    p, st = params[arch], adamw_init(params[arch], ocfg)
    for i in (1, 2):
        p, st, om = upd(grads[arch], st, p)
        flat(f"{{arch}}/adamw/{{i}}/params", p)
        flat(f"{{arch}}/adamw/{{i}}/m", st.m)
        flat(f"{{arch}}/adamw/{{i}}/v", st.v)
        flat(f"{{arch}}/adamw/{{i}}/metrics", om)

with jaxcompat.use_mesh(make_host_mesh()):
    # two microbatches, the f32 scan accumulation
    cfg = cfg_of({mb_arch!r})
    step = jax.jit(make_train_step(cfg, ocfg, microbatches=2, remat="none"))
    p, st, om = step(params[{mb_arch!r}], adamw_init(params[{mb_arch!r}], ocfg),
                     batch_of("mb/batch"))
    flat("mb/metrics", om)
    flat("mb/m", st.m)
    # three steps on the synthetic data
    for arch in {step_archs!r}:
        cfg = cfg_of(arch)
        step = jax.jit(make_train_step(cfg, ocfg, remat="none"))
        p, st = params[arch], adamw_init(params[arch], ocfg)
        for i in range({steps}):
            p, st, om = step(p, st, batch_of(f"steps/{{i}}"))
            out[f"{{arch}}/steps/{{i}}"] = om["loss"]
np.savez({out_path!r}, **out)
print("REFERENCE_OK")
"""


def _inputs():
    rng = np.random.default_rng(25)
    inp = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        labels = rng.integers(0, 512, (B, S)).astype(np.int32)
        labels[rng.random((B, S)) < 0.2] = -1
        batch = extra_model_inputs(cfg, {
            "tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
            "labels": labels}, n_vis=N_VIS)
        inp.update({f"{arch}/batch/{k}": v for k, v in batch.items()})
    d = _cfg(MOE_ARCHS[0]).d_model
    one = rng.standard_normal((1, 1, d)).astype(np.float32)
    inp["moe/flood"] = np.repeat(one, 16, axis=1).reshape(4, 4, d)
    inp["moe/r"] = rng.standard_normal((4, 4, d)).astype(np.float32)
    # ties: values on a grid of 0.25, some rows all equal
    scores = np.round(rng.standard_normal((6, 40)) * 4) / 4
    scores[0] = 0.5
    inp["topk/scores"] = scores.astype(np.float32)
    inp["topk/g"] = rng.standard_normal((6, TOPK_K)).astype(np.float32)
    inp["mb/batch/tokens"] = rng.integers(0, 512, (4, S)).astype(np.int32)
    inp["mb/batch/labels"] = rng.integers(0, 512, (4, S)).astype(np.int32)
    data = SyntheticLM(vocab_size=512, seq_len=S, global_batch=B, seed=3)
    for i in range(STEPS):
        inp.update({f"steps/{i}/{k}": v for k, v in data.batch_at(i).items()})
    return inp


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(inputs, reference outputs), all from one subprocess."""
    d = tmp_path_factory.mktemp("train_ref")
    inp = _inputs()
    np.savez(d / "inp.npz", **inp)
    out = run_with_devices(_REFERENCE.format(
        inp=str(d / "inp.npz"), out_path=str(d / "out.npz"),
        archs=ARCHS, moe_archs=MOE_ARCHS, opt_archs=OPT_ARCHS,
        step_archs=STEP_ARCHS, mb_arch=MB_ARCH, steps=STEPS, k=TOPK_K,
        opt=OPT, max_seq=MAX_SEQ), n_devices=1, timeout=900)
    assert "REFERENCE_OK" in out
    return inp, dict(np.load(d / "out.npz"))


def _params(out, arch):
    cfg = _cfg(arch)
    return cfg, params_of(out, arch, cfg, M)


def _batch(inp, prefix):
    n = len(prefix) + 1
    return {k[n:]: t(v) for k, v in inp.items() if k.startswith(prefix + "/")}


def _grads(params, loss):
    names, leaves = zip(*params.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, leaves)))


# --------------------------------------------------------------------------
# loss_fn and its gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(ref, arch):
    inp, out = ref
    cfg, params = _params(out, arch)
    batch = _batch(inp, f"{arch}/batch")
    loss, aux = M.loss_fn(params, cfg, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    torch.testing.assert_close(loss.detach(), t(out[f"{arch}/loss"]),
                               **LOSS_TOL)
    for key in ("ce", "aux", "n_tok"):
        torch.testing.assert_close(aux[key].detach(),
                                   t(out[f"{arch}/aux/{key}"]), **LOSS_TOL)
    assert float(aux["n_tok"]) == float((batch["labels"] >= 0).sum())
    assert (float(aux["aux"].detach()) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(ref, arch):
    inp, out = ref
    cfg, params = _params(out, arch)
    loss, _ = M.loss_fn(params, cfg, _batch(inp, f"{arch}/batch"))
    grads = _grads(params, loss)
    pre = f"{arch}/grads/"
    assert {ref_leaf(n, cfg)[0] for n in grads} == {
        k[len(pre):] for k in out if k.startswith(pre)}
    for name, g in grads.items():
        want = t(ref_value(out, f"{arch}/grads", name, cfg))
        torch.testing.assert_close(g, want, **GRAD_TOL, msg=name)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gradients_with_drops_match_reference(ref, arch):
    """16 equal tokens, top-2 of 4 experts, capacity 10: each of the two
    experts drops the last 6 tokens; the gradients of <y, r> + aux with
    respect to the FFN's weights and the input."""
    inp, out = ref
    cfg, params = _params(out, arch)
    ffn = params.layers[0].ffn
    x = t(inp["moe/flood"]).requires_grad_(True)
    y, aux = moe.apply_moe(ffn, x, cfg)
    names, leaves = zip(*ffn.named_parameters())
    got = torch.autograd.grad((y * t(inp["moe/r"])).sum() + aux,
                              (x, *leaves))
    torch.testing.assert_close(got[0], t(out[f"{arch}/moe_grads/x"]),
                               **GRAD_TOL)
    for name, g in zip(names, got[1:]):
        want = t(out[f"{arch}/moe_grads/ffn/{name.replace('.', '/')}"])
        torch.testing.assert_close(g, want, **GRAD_TOL, msg=name)


# --------------------------------------------------------------------------
# the top-k with a gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 7])
def test_topk_with_grad_forward_is_local_topk(ref, offset):
    inp, _ = ref
    s = t(inp["topk/scores"])
    v, i = topk_with_grad(s.clone().requires_grad_(True), TOPK_K,
                          index_offset=offset)
    v0, i0 = local_topk(s, TOPK_K, index_offset=offset)
    assert torch.equal(v.detach(), v0) and torch.equal(i, i0)
    assert v.requires_grad and not i.requires_grad


@pytest.mark.parametrize("offset", [0, 7])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_topk_with_grad_backward_is_the_scatter(ref, dt, offset):
    """The scores' gradient is the values' gradient scattered back to the
    winners (global indices less ``index_offset``), zero elsewhere, in
    the scores' dtype: ``lax.top_k``'s VJP, bit for bit."""
    inp, out = ref
    s = t(inp["topk/scores"]).to(dt).requires_grad_(True)
    g = t(inp["topk/g"])
    v, i = topk_with_grad(s, TOPK_K, index_offset=offset)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    (gs,) = torch.autograd.grad(v, s, g)
    assert gs.dtype == dt
    want = torch.zeros_like(s).scatter(-1, i.long() - offset, g.to(dt))
    assert torch.equal(gs, want)
    ref_g = t(out[f"topk/vjp/{str(dt).split('.')[-1]}"]).to(dt)
    assert torch.equal(gs, ref_g)


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_equal_losses_and_grads(ref, arch, monkeypatch):
    """Remat changes no value: ``none``, ``full`` and ``dots`` give the
    same loss and gradients, bit for bit on the CPU; under remat each
    router's top-k runs again in the backward."""
    inp, out = ref
    cfg, params = _params(out, arch)
    batch = _batch(inp, f"{arch}/batch")
    calls = []
    real = moe.topk_with_grad

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(moe, "topk_with_grad", spy)
    got = {}
    for remat in ("none", "full", "dots"):
        calls.clear()
        loss, _ = M.loss_fn(params, cfg, batch, remat=remat)
        got[remat] = (loss.detach(), _grads(params, loss), len(calls))
    n_moe = cfg.n_layers if cfg.moe is not None else 0
    assert [got[r][2] for r in got] == [n_moe, 2 * n_moe, 2 * n_moe]
    for remat in ("full", "dots"):
        assert torch.equal(got[remat][0], got["none"][0])
        for name, g in got["none"][1].items():
            assert torch.equal(got[remat][1][name], g), (remat, name)


def test_unknown_remat_is_refused(ref):
    inp, out = ref
    cfg, params = _params(out, "qwen2-0.5b")
    with pytest.raises(ValueError, match="unknown remat"):
        M.loss_fn(params, cfg, _batch(inp, "qwen2-0.5b/batch"),
                  remat="offload")


# --------------------------------------------------------------------------
# the optimizer and the train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", OPT_ARCHS)
def test_adamw_update_matches_reference(ref, arch):
    """Two updates from the reference's weights with the reference's
    gradients: parameters, moments and metrics on identical inputs, the
    decay by reference fault 9's rule."""
    _, out = ref
    cfg, params = _params(out, arch)
    ocfg = AdamWConfig(**OPT)
    grads = {n: t(ref_value(out, f"{arch}/grads", n, cfg))
             for n, _ in params.named_parameters()}
    state = adamw_init(params, ocfg)
    decay = decayed(params, cfg)
    for i in (1, 2):
        params, state, om = adamw_update(grads, state, params, ocfg, decay)
        assert int(state.step) == i and state.step.dtype == torch.int32
        pre = f"{arch}/adamw/{i}"
        for key in ("grad_norm", "lr"):
            torch.testing.assert_close(om[key], t(out[f"{pre}/metrics/{key}"]),
                                       **OPT_TOL)
        for name, p in params.named_parameters():
            for what, got in (("params", p), ("m", state.m[name]),
                              ("v", state.v[name])):
                want = t(ref_value(out, f"{pre}/{what}", name, cfg))
                torch.testing.assert_close(got.detach(), want, **OPT_TOL,
                                           msg=f"{what} {name}")


def test_microbatches_match_reference_scan(ref):
    """``microbatches=2``: the loss and the global norm of the f32 sum,
    the rate, and the first moment (0.1 times the clipped mean gradient)
    against the reference's scan."""
    inp, out = ref
    cfg, params = _params(out, MB_ARCH)
    ocfg = AdamWConfig(**OPT)
    step = make_train_step(cfg, ocfg, microbatches=2, remat="none")
    params, state, om = step(params, adamw_init(params, ocfg),
                             _batch(inp, "mb/batch"))
    torch.testing.assert_close(om["loss"], t(out["mb/metrics/loss"]),
                               **LOSS_TOL)
    torch.testing.assert_close(om["grad_norm"],
                               t(out["mb/metrics/grad_norm"]), rtol=1e-4,
                               atol=0.0)
    torch.testing.assert_close(om["lr"], t(out["mb/metrics/lr"]), **OPT_TOL)
    for name, m in state.m.items():
        want = t(ref_value(out, "mb/m", name, cfg))
        torch.testing.assert_close(m / (1 - ocfg.b1), want / (1 - ocfg.b1),
                                   **GRAD_TOL, msg=name)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_three_train_steps_match_reference(ref, arch):
    inp, out = ref
    cfg, params = _params(out, arch)
    ocfg = AdamWConfig(**OPT)
    step = make_train_step(cfg, ocfg, remat="none")
    state = adamw_init(params, ocfg)
    for i in range(STEPS):
        params, state, om = step(params, state, _batch(inp, f"steps/{i}"))
        torch.testing.assert_close(om["loss"], t(out[f"{arch}/steps/{i}"]),
                                   rtol=1e-4, atol=0.0)
