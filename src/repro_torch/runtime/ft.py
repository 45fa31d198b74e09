"""Fault tolerance at the driver level — the paper's §4 dynamicity
handling applied to a training loop (a copy of the reference's
``runtime/ft.py``, which imports no JAX; the port keeps its own).

Mapping from the paper:
  * wait-time cost model (Appendix A) -> ``StragglerWatchdog``: a step that
    exceeds ``timeout_fn(step_params)`` is declared a straggler, exactly
    the peer whose score-list misses the wait window.
  * urgent score-lists / alternative paths -> ``run_with_recovery``: work
    lost to a failure is NOT discarded; the driver restores the latest
    checkpoint and requeues the remaining steps (the information still
    reaches the "originator", late).
  * k-inflation (Lemma 4) -> over-provisioning hooks: the recovery driver
    accepts ``spare_fraction`` so a deployment reserves hot spares, and
    compress.inflate_k applies the same lemma to gradient k-lists.

The watchdog times the step in its own thread, so the step must wait
for the device there: the training driver reads the loss back
(``float(loss)``, a synchronisation) inside the step, or a step would
return as soon as its kernels were queued.  Failures surface as
exceptions (a CUDA error is a ``RuntimeError``), which the recovery loop
catches.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Optional


# --------------------------------------------------------------------------
# failure model (for tests / simulation; exponential lifetimes as in the
# paper's §5.4 churn study)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FailureInjector:
    """Deterministic-seeded exponential failure process."""
    mtbf_steps: float = float("inf")
    seed: int = 0
    _step: int = 0

    def tick(self) -> bool:
        """Advance one step; True -> inject a failure now."""
        import numpy as np
        self._step += 1
        if self.mtbf_steps == float("inf"):
            return False
        rng = np.random.default_rng((self.seed, self._step))
        return bool(rng.random() < 1.0 / self.mtbf_steps)


class SimulatedFailure(RuntimeError):
    pass


# --------------------------------------------------------------------------
# straggler watchdog (Appendix A wait time -> step timeout)
# --------------------------------------------------------------------------

class StragglerTimeout(RuntimeError):
    pass


class StragglerWatchdog:
    """Run a callable with a wall-clock budget.

    ``timeout_s`` plays the paper's Wait_p(Q, ttl) role: generous enough
    not to cut off healthy peers, tight enough to catch dead ones.  The
    default budget auto-calibrates to ``factor`` x the rolling median
    step time (network/load-adaptive, like the paper's statistics-based
    estimation of T_Qsnd / T_SLsnd).
    """

    def __init__(self, *, timeout_s: Optional[float] = None,
                 factor: float = 5.0, min_timeout_s: float = 1.0):
        self.timeout_s = timeout_s
        self.factor = factor
        self.min_timeout_s = min_timeout_s
        self._times: list = []

    def budget(self) -> float:
        if self.timeout_s is not None:
            return self.timeout_s
        if not self._times:
            return float("inf")
        med = sorted(self._times)[len(self._times) // 2]
        return max(self.min_timeout_s, self.factor * med)

    def run(self, fn: Callable[[], Any]) -> Any:
        budget = self.budget()
        result: dict = {}

        def target():
            try:
                result["value"] = fn()
            except BaseException as e:      # noqa: BLE001
                result["error"] = e

        t0 = time.monotonic()
        th = threading.Thread(target=target, daemon=True)
        th.start()
        th.join(timeout=None if budget == float("inf") else budget)
        if th.is_alive():
            raise StragglerTimeout(
                f"step exceeded {budget:.2f}s watchdog budget")
        if "error" in result:
            raise result["error"]
        self._times.append(time.monotonic() - t0)
        if len(self._times) > 64:
            self._times.pop(0)
        return result["value"]


# --------------------------------------------------------------------------
# recovery driver
# --------------------------------------------------------------------------

def run_with_recovery(step_fn: Callable[[int, Any], Any], state: Any,
                      *, n_steps: int, ckpt_manager=None,
                      restore_fn: Optional[Callable[[], Any]] = None,
                      watchdog: Optional[StragglerWatchdog] = None,
                      max_failures: int = 8,
                      on_failure: Optional[Callable[[int, Exception], None]]
                      = None,
                      start_step: int = 0, mesh=None) -> Any:
    """Run ``state = step_fn(step, state)`` for n_steps with checkpoint/
    restart.  On failure: restore the latest checkpoint (or ``restore_fn``)
    and requeue from there.  Returns the final state.

    Over a mesh whose axes span ranks (``mesh``), every rank runs this
    loop and the checkpoint manager saves and restores collectively, so
    all ranks resume from the same step (rank 0's, broadcast).  A
    failure on any rank stops the group: it is raised at once, not
    retried, since its peers may be waiting in a collective of the
    failed step (``launch/ranks.py::spawn_ranks`` then ends the other
    ranks); a rerun resumes every rank from the last checkpoint.
    """
    over_ranks = mesh is not None and mesh.multi_rank
    failures = 0
    step = start_step
    while step < n_steps:
        try:
            if watchdog is not None:
                state = watchdog.run(lambda: step_fn(step, state))
            else:
                state = step_fn(step, state)
            if ckpt_manager is not None:
                ckpt_manager.maybe_save(step + 1, state)
            step += 1
        except Exception as e:              # noqa: BLE001
            if over_ranks:
                raise
            failures += 1
            if on_failure is not None:
                on_failure(step, e)
            if failures > max_failures:
                raise
            if restore_fn is not None:
                restored = restore_fn()
                if restored is not None:
                    restored_step, restored_state = restored
                    if restored_state is not None:
                        step, state = restored_step, restored_state
            # else: retry the same step with the in-memory state
    if ckpt_manager is not None:
        ckpt_manager.maybe_save(step, state, force=True)
        ckpt_manager.wait()
    return state
