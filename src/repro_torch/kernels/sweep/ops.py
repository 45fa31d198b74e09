"""Public entries of the forward-sweep kernels: the kernels on the
card, the plain versions on the CPU (mirrors ``merge/ops.py``)."""
from __future__ import annotations

from repro_torch.kernels.sweep.ref import arrivals_ref, wait_ref
from repro_torch.kernels.sweep.sweep import arrivals_cuda, wait_cuda


def _route(t, name):
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no path for {kind} tensors")
    return kind == "cuda"


def level_arrivals(tq_prev, dn, par_pos):
    """Level-d arrival times ``tq_prev[:, par_pos] + dn``."""
    if _route(tq_prev, "level_arrivals"):
        return arrivals_cuda(tq_prev, dn, par_pos)
    return arrivals_ref(tq_prev, dn, par_pos)


def wait_propagate(own_ready, all_in, deadline, *, death=None):
    """Appendix-A send times; with ``death`` also the churn-masked send.

    Returns ``s`` (E, L), or ``(s, send)`` when ``death`` is given,
    with ``send = where(death >= s, s, inf)``.
    """
    if _route(own_ready, "wait_propagate"):
        return wait_cuda(own_ready, all_in, deadline, death)
    return wait_ref(own_ready, all_in, deadline, death)
