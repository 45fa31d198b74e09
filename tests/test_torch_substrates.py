"""The port's training substrates on the CPU: AdamW (the cosine schedule,
clipping, the quadratic convergence of tests/test_substrates.py, and
reference fault 9's decay rule read from the reference's own tree and
update), ``SyntheticLM`` bit-equal to the reference's, checkpoints (bf16
/ f32 / int32 round trip, a shape mismatch refused, keep-N in the
blocking and async cases and across a forced re-save, reference fault 3
shown beside the reference's manager), the fault-tolerance driver, and
the training CLI (``python -m repro_torch.launch.train``) in process and
as ``-m``, with a resume from a checkpoint directory.

Only ``test_decay_rule_is_the_references`` compiles JAX (one jitted
``adamw_update`` a config); the other reference pieces are numpy or
shapes (``jax.eval_shape``).
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                         restore, save)
from repro_torch.configs.base import get_config, smoke_config
from repro_torch.data.pipeline import SyntheticLM, device_put_batch
from repro_torch.launch import train as train_mod
from repro_torch.models import model as M
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, cosine_lr, decayed)
from repro_torch.runtime.ft import (FailureInjector, StragglerTimeout,
                                    StragglerWatchdog, run_with_recovery)

ROOT = Path(__file__).resolve().parents[1]


def _module(**tensors):
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=200, grad_clip=1e9)
    params = _module(w=torch.tensor([5.0, -3.0]))
    opt = adamw_init(params, cfg)
    for _ in range(150):
        grads = {"w": 2 * params["w"].detach()}     # d/dw ||w||^2
        params, opt, m = adamw_update(grads, opt, params, cfg, {"w": False})
    assert float(params["w"].detach().abs().max()) < 0.2
    assert int(opt.step) == 150


def test_cosine_schedule():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                      min_lr_ratio=0.1)
    assert float(cosine_lr(cfg, torch.tensor(0))) == 0.0
    assert float(cosine_lr(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(cosine_lr(cfg, torch.tensor(110))) == pytest.approx(0.1)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 60, 110, 200])
def test_cosine_schedule_matches_reference(step):
    import jax.numpy as jnp
    from repro.optim.adamw import AdamWConfig as RefConfig
    from repro.optim.adamw import cosine_lr as ref_cosine_lr
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    got = cosine_lr(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    want = np.asarray(ref_cosine_lr(RefConfig(**kw),
                                    jnp.asarray(step, jnp.int32)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_grad_clip_applied():
    cfg = AdamWConfig(lr=0.0, grad_clip=1.0)
    params = _module(w=torch.ones((4,)))
    opt = adamw_init(params, cfg)
    _, _, metrics = adamw_update({"w": torch.full((4,), 100.0)}, opt, params,
                                 cfg, {"w": False})
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    # lr 0: the parameters stay, the moments take the clipped gradient
    assert torch.equal(params["w"].detach(), torch.ones(4))
    torch.testing.assert_close(opt.m["w"], torch.full((4,), 0.1 * 0.5))


def test_bf16_parameters_update_in_f32_and_stay_bf16():
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0)
    w = torch.tensor([[1.0, -2.0], [0.5, 3.0]], dtype=torch.bfloat16)
    params = _module(w=w.clone())
    opt = adamw_init(params, cfg)
    g = torch.tensor([[0.3, -0.1], [0.0, 2.0]], dtype=torch.bfloat16)
    params, opt, _ = adamw_update({"w": g}, opt, params, cfg, {"w": True})
    assert params["w"].dtype == torch.bfloat16
    assert opt.m["w"].dtype == opt.v["w"].dtype == torch.float32
    # step 1: m_hat / sqrt(v_hat) is the sign of the clipped gradient
    gd = g.double()
    delta = torch.sign(gd) * (gd.abs() / (gd.abs() + 1e-8))
    lr = float(cosine_lr(cfg, 1))
    want = w.double() - lr * (delta + 0.1 * w.double())
    torch.testing.assert_close(params["w"].detach().double(), want,
                               rtol=2 ** -8, atol=0.0)


# --------------------------------------------------------------------------
# reference fault 9: the reference decays every leaf of a stacked layer
# --------------------------------------------------------------------------

def _fault9_cfg(arch):
    cfg = smoke_config(get_config(arch))
    if arch == "recurrentgemma-2b":      # 1 group of 3 + 2 remainder
        cfg = dataclasses.replace(cfg, n_layers=5)
    return cfg


def _flat(tree, prefix="", out=None):
    """A reference pytree's leaves under "/"-joined keys."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}" if prefix else k, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = tree
    return out


def _ref_tree(cfg):
    """The reference's parameter shapes (``jax.eval_shape``)."""
    import jax
    from repro.models import model as RM
    return jax.eval_shape(lambda k: RM.init_params(k, cfg, max_seq=64),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_decay_rule_is_the_references(arch):
    """The reference decays a leaf where its tree's leaf has ndim >= 2
    (``src/repro/optim/adamw.py:72``), and its scanned groups stack their
    layers, so their norms and biases are decayed there: one jitted
    reference update of all-ones weights with zero gradients moves
    exactly the decayed leaves, and those are ``decayed``'s."""
    import jax
    import jax.numpy as jnp
    from repro.optim.adamw import AdamWConfig as RefConfig
    from repro.optim.adamw import adamw_init as ref_init
    from repro.optim.adamw import adamw_update as ref_update
    from torch_lm_ref import ref_leaf
    cfg = _fault9_cfg(arch)
    tree = _ref_tree(cfg)
    shapes = _flat(tree)
    ones = jax.tree.map(lambda s: jnp.ones(s.shape, s.dtype), tree)
    zeros = jax.tree.map(jnp.zeros_like, ones)
    rcfg = RefConfig(warmup_steps=0)
    new, _, _ = jax.jit(lambda g, s, p: ref_update(g, s, p, rcfg))(
        zeros, ref_init(ones, rcfg), ones)
    ref_decayed = {k: bool((np.asarray(v) != 1).any())
                   for k, v in _flat(new).items()}
    assert ref_decayed == {k: len(s.shape) >= 2 for k, s in shapes.items()}
    params = M.init_params(torch.Generator().manual_seed(0), cfg, max_seq=64,
                           device="cpu")
    mask = decayed(params, cfg)
    for name, p in params.named_parameters():
        assert mask[name] == ref_decayed[ref_leaf(name, cfg)[0]], name
    assert not mask["norm_f.scale"]
    if arch == "qwen2-0.5b":
        assert shapes["dec/groups/0/norm1/scale"].shape == (2, 128)
        for leaf in ("norm1.scale", "norm2.scale", "mixer.b_q", "mixer.b_k",
                     "mixer.b_v"):
            assert mask[f"layers.0.{leaf}"] and mask[f"layers.1.{leaf}"]
            assert getattr(params.layers[0], leaf.split(".")[0])[
                leaf.split(".")[1]].ndim == 1
    else:
        for i in range(5):               # grouped 0-2, remainder 3-4
            assert mask[f"layers.{i}.norm1.scale"] == (i < 3)
            assert mask[f"layers.{i}.norm2.scale"] == (i < 3)
        # a 2-D parameter of a remainder layer is decayed either way
        assert mask["layers.3.mixer.w_x"]


def test_decay_rule_covers_the_encoder():
    """whisper's encoder layers are stacked (pattern ("attn",)), its
    ``enc.norm_f`` is not."""
    cfg = smoke_config(get_config("whisper-large-v3"))
    params = M.init_params(torch.Generator().manual_seed(0), cfg, max_seq=64,
                           device="cpu")
    mask = decayed(params, cfg)
    assert mask["enc.layers.0.norm1.bias"] and mask["enc.layers.1.norm2.scale"]
    assert not mask["enc.norm_f.scale"] and not mask["enc.norm_f.bias"]
    assert mask["pos_embed"] and mask["embed"]


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("step", [0, 1, 17])
def test_synthetic_batches_are_the_references(seed, step):
    from repro.data.pipeline import SyntheticLM as RefSyntheticLM
    kw = dict(vocab_size=151_936, seq_len=64, global_batch=4, seed=seed)
    got, want = SyntheticLM(**kw).batch_at(step), \
        RefSyntheticLM(**kw).batch_at(step)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for key in got:
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])


def test_data_deterministic_and_restartable():
    d1 = SyntheticLM(vocab_size=100, seq_len=32, global_batch=4, seed=5)
    d2 = SyntheticLM(vocab_size=100, seq_len=32, global_batch=4, seed=5)
    b1, b2 = d1.batch_at(17), d2.batch_at(17)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert b1["tokens"].max() < 100
    d2.step = 17                         # the restart cursor
    it = iter(d2)
    np.testing.assert_array_equal(next(it)["labels"], b1["labels"])
    np.testing.assert_array_equal(next(it)["tokens"],
                                  d1.batch_at(18)["tokens"])


def test_device_put_batch_keeps_dtypes():
    raw = SyntheticLM(vocab_size=50, seq_len=8, global_batch=2).batch_at(0)
    raw["frames"] = np.ones((2, 3, 4), np.float32)
    got = device_put_batch(raw, "cpu")
    assert got["tokens"].dtype == torch.int32
    assert got["frames"].dtype == torch.float32
    assert all(v.device.type == "cpu" for v in got.values())
    np.testing.assert_array_equal(got["labels"].numpy(), raw["labels"])


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.arange(6).reshape(2, 3).to(torch.float32),
            "b": {"c": torch.ones((4,), dtype=torch.int32)},
            "w": torch.randn((3, 5), generator=g).to(torch.bfloat16)}


def _bits(x):
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    t["w"][0, 0] = float("nan")          # bits, not values
    save(str(tmp_path), 7, t)
    assert latest_step(str(tmp_path)) == 7
    spec = json.loads((tmp_path / "step_00000007" / "tree.json").read_text())
    assert spec["n_leaves"] == 3 and spec["step"] == 7
    assert spec["dtypes"] == ["float32", "int32", "bfloat16"]
    assert np.load(tmp_path / "step_00000007" / "leaf_00002.npy").dtype \
        == np.int16
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)},
            "w": torch.zeros(3, 5)}
    got = restore(str(tmp_path), 7, like, device="cpu")
    for key, want in (("a", t["a"]), ("w", t["w"])):
        assert got[key].dtype == want.dtype
        assert torch.equal(_bits(got[key]), _bits(want))
    assert got["b"]["c"].dtype == torch.int32
    assert torch.equal(got["b"]["c"], t["b"]["c"])


def test_module_and_optimizer_state_round_trip(tmp_path):
    """An LM (bf16 weights) and its AdamWState: the module restored in
    place from its state_dict, the state as new tensors, every bit."""
    cfg = dataclasses.replace(smoke_config(get_config("qwen2-0.5b")),
                              param_dtype="bfloat16")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, max_seq=64,
                           device="cpu")
    opt = adamw_init(params, AdamWConfig())
    opt = AdamWState(opt.step + 3, {n: torch.randn(m.shape)
                                    for n, m in opt.m.items()}, opt.v)
    save(str(tmp_path), 3, (params, opt))
    other = M.init_params(torch.Generator().manual_seed(1), cfg, max_seq=64,
                          device="cpu")
    got_p, got_o = restore(str(tmp_path), 3,
                           (other, adamw_init(other, AdamWConfig())),
                           device="cpu")
    assert got_p is other and isinstance(got_o, AdamWState)
    for (n, a), (_, b) in zip(params.named_parameters(),
                              got_p.named_parameters()):
        assert b.dtype == torch.bfloat16 and b.requires_grad
        assert torch.equal(_bits(a.detach()), _bits(b.detach())), n
    assert got_o.step.dtype == torch.int32 and int(got_o.step) == 3
    for n in opt.m:
        assert torch.equal(got_o.m[n], opt.m[n])
        assert torch.equal(got_o.v[n], opt.v[n])


def test_shape_mismatch_rejected(tmp_path):
    save(str(tmp_path), 1, {"a": torch.ones((2,))})
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path), 1, {"a": torch.zeros(3)}, device="cpu")


def test_snapshot_is_taken_before_the_write(tmp_path):
    """The async write holds a host copy: the tensor may change at once
    (training goes on in place) without changing the checkpoint."""
    t = {"a": torch.zeros(1000)}
    th = save(str(tmp_path), 1, t, blocking=False)
    t["a"] += 1
    th.join()
    got = restore(str(tmp_path), 1, {"a": torch.empty(1000)}, device="cpu")
    assert not got["a"].any()


def _steps(d):
    return sorted(int(n[5:]) for n in os.listdir(d)
                  if n.startswith("step_") and not n.endswith(".tmp"))


def test_reference_fault3_blocking_keeps_one_too_few(tmp_path):
    """Reference fault 3: the reference's ``_gc`` lists the directory
    after the write started, so a blocking write is counted among the
    ``keep - 1`` it keeps: after five saves at keep 3 two remain.  The
    port lists the checkpoints that were complete before the write and
    keeps three."""
    from repro.ckpt.checkpoint import CheckpointManager as RefManager
    ref = RefManager(str(tmp_path / "ref"), save_every=1, keep=3,
                     blocking=True)
    port = CheckpointManager(str(tmp_path / "port"), save_every=1, keep=3,
                             blocking=True)
    for s in range(1, 6):
        ref.maybe_save(s, {"a": np.ones((2,), np.float32)})
        port.maybe_save(s, {"a": torch.ones(2)})
    assert _steps(tmp_path / "ref") == [4, 5]
    assert _steps(tmp_path / "port") == [3, 4, 5]


@pytest.mark.parametrize("blocking", [True, False])
@pytest.mark.parametrize("keep", [1, 2, 3])
def test_keep_n_with_a_forced_resave(tmp_path, blocking, keep):
    """``keep`` checkpoints remain after saves 1..5 and again after a
    forced re-save of step 5 (what ``run_with_recovery`` does last)."""
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=keep,
                            blocking=blocking)
    for s in range(1, 6):
        mgr.maybe_save(s, _tree())
    mgr.wait()
    assert _steps(tmp_path) == list(range(6 - keep, 6))
    assert mgr.maybe_save(5, _tree(), force=True)
    mgr.wait()
    assert _steps(tmp_path) == list(range(6 - keep, 6))


def test_save_every_and_restore_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=2, blocking=False)
    t = _tree()
    assert not mgr.maybe_save(0, t) and not mgr.maybe_save(3, t)
    assert mgr.maybe_save(4, t)
    step, got = mgr.restore_latest(t, device="cpu")
    assert step == 4
    assert torch.equal(_bits(got["w"]), _bits(t["w"]))
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest(t, device="cpu") == (None, None)


# --------------------------------------------------------------------------
# fault tolerance
# --------------------------------------------------------------------------

def test_failure_injector_is_the_references():
    from repro.runtime.ft import FailureInjector as RefInjector
    a, b = FailureInjector(mtbf_steps=4.0, seed=3), RefInjector(4.0, 3)
    assert [a.tick() for _ in range(50)] == [b.tick() for _ in range(50)]
    assert not any(FailureInjector().tick() for _ in range(10))


def test_watchdog_catches_straggler():
    wd = StragglerWatchdog(timeout_s=0.2)
    with pytest.raises(StragglerTimeout):
        wd.run(lambda: time.sleep(2.0))
    assert wd.run(lambda: 42) == 42


def test_watchdog_budget_follows_the_median():
    wd = StragglerWatchdog(factor=5.0, min_timeout_s=0.01)
    assert wd.budget() == float("inf")
    for _ in range(3):
        wd.run(lambda: time.sleep(0.02))
    assert 0.1 <= wd.budget() < 1.0
    with pytest.raises(ValueError):
        wd.run(lambda: int("x"))         # the step's own error, re-raised


def test_recovery_restores_and_completes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=1, blocking=True)
    inj = FailureInjector(mtbf_steps=4.0, seed=1)
    calls = {"fail": 0}

    def step(i, state):
        if inj.tick():
            calls["fail"] += 1
            raise RuntimeError("simulated pod failure")
        return state + 1

    zero = torch.tensor(0)
    final = run_with_recovery(
        step, zero, n_steps=20, ckpt_manager=mgr,
        restore_fn=lambda: mgr.restore_latest(zero, device="cpu"),
        max_failures=50)
    assert int(final) == 20
    assert calls["fail"] > 0                     # failures actually hit
    assert latest_step(str(tmp_path)) == 20


def test_recovery_gives_up_after_max():
    def step(i, state):
        raise RuntimeError("always fails")
    with pytest.raises(RuntimeError):
        run_with_recovery(step, 0, n_steps=3, max_failures=2)


# --------------------------------------------------------------------------
# the training CLI
# --------------------------------------------------------------------------

SMOKE = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
         "--seq", "32", "--log-every", "1"]


def _reference_count(arch, seq):
    import jax
    from repro.models import model as RM
    cfg = smoke_config(get_config(arch))
    tree = jax.eval_shape(lambda k: RM.init_params(k, cfg,
                                                   max_seq=max(seq, 128)),
                          jax.random.PRNGKey(0))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


def _check_lines(out, arch, steps, resumed=None):
    lines = out.strip().splitlines()
    assert lines[0] == (f"arch={arch} params={_reference_count(arch, 32):,} "
                        "mesh={'data': 1, 'model': 1} devices=1")
    if resumed is not None:
        assert lines[1] == f"resumed from step {resumed}"
    logged = [int(m[1]) for m in re.finditer(
        r"^step +(\d+)  loss \d+\.\d{4}  gnorm \d+\.\d{3}  lr \d\.\d\de-\d\d  "
        r"\d+\.\ds$", out, re.M)]
    assert logged == list(range(resumed or 0, steps))
    assert re.search(r"^done: first loss \d+\.\d{4} -> last \d+\.\d{4}$",
                     lines[-1])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-1b-a400m"])
def test_train_cli_in_process(capsys, arch):
    losses = train_mod.main(SMOKE + ["--arch", arch])
    assert len(losses) == 3 and all(np.isfinite(losses))
    _check_lines(capsys.readouterr().out, arch, 3)


def test_train_cli_microbatches_remat_and_watchdog(capsys):
    losses = train_mod.main(SMOKE + ["--microbatches", "2", "--remat", "dots",
                                     "--watchdog", "--model-par", "4"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    _check_lines(capsys.readouterr().out, "qwen2-0.5b", 3)


def test_train_cli_resumes_from_a_checkpoint(capsys, tmp_path):
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = train_mod.main(SMOKE + ck)
    _check_lines(capsys.readouterr().out, "qwen2-0.5b", 3)
    assert _steps(tmp_path) == [2, 3]
    losses, (params, opt) = train_mod.run(
        [a if a != "3" else "5" for a in SMOKE] + ck)
    _check_lines(capsys.readouterr().out, "qwen2-0.5b", 5, resumed=3)
    assert len(losses) == 2 and int(opt.step) == 5
    assert _steps(tmp_path) == [3, 4, 5]
    assert len(first) == 3


def test_train_cli_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *SMOKE,
         "--ckpt-dir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    _check_lines(out.stdout, "qwen2-0.5b", 3)
    assert _steps(tmp_path) == [3]


@pytest.mark.parametrize("argv", [[], ["--smoke", "--steps", "1"]])
def test_train_defaults_to_cuda_and_raises_without_it(monkeypatch, argv):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_mod.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.build("qwen2-0.5b", smoke=True, batch=2, seq=8,
                        model_par=1, microbatches=1, remat="none", lr=1e-3,
                        steps=1)
