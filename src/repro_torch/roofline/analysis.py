"""Roofline terms of a traced step, against one NVIDIA H100.

    compute   = flops / peak_flops              (per rank: the trace is
    memory    = bytes / hbm_bw                   one rank's step)
    collective= collective_bytes / link_bw

The reference (``src/repro/roofline/analysis.py``) reads its three
inputs from a compiled SPMD module and charges them to a TPU.  The port
has no compiled module: ``roofline/trace.py`` counts the FLOPs, the
bytes and the collectives of one rank's eager step, and
``collective_bytes_from_hlo`` has no counterpart here, since that
counter sees every ``c10d`` collective the rank issues (and with it
goes the reference's ``DTYPE_BYTES``: a tensor knows its item size).

``roofline_terms`` and ``model_flops_estimate`` are the reference's,
unchanged; ``collective_terms`` charges each mesh axis's collective
bytes apart (the ``"pod"`` axis across hosts).  ``HW`` holds the H100
SXM data sheet's figures, dense rates without sparsity at the card's
full 700 W; a card set to a lower power limit runs below them.  Every
term is therefore a data-sheet bound, not a measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12       # bf16 dense, per card
    hbm_bw: float = 3.35e12          # bytes/s of HBM3, per card
    link_bw: float = 450e9           # bytes/s of NVLink, each way, per card
    # bytes/s of the host NIC a card is charged across hosts: a DGX H100
    # has one 400 Gb/s NDR InfiniBand adapter a GPU (NVIDIA DGX H100
    # user guide, "network ports": 8 x single-port ConnectX-7).
    # roofline_terms, the reference's, charges every collective to
    # link_bw; collective_terms charges the "pod" axis's bytes here
    dcn_bw: float = 50e9
    hbm_bytes: float = 80e9          # device memory, per card


def roofline_terms(*, hlo_flops: float, hlo_bytes: float,
                   collective_bytes: float, hw: HW = HW(),
                   model_flops: Optional[float] = None,
                   chips: int = 1) -> dict:
    """Three terms in seconds (per-device module convention) + verdict."""
    compute_s = hlo_flops / hw.peak_flops
    memory_s = hlo_bytes / hw.hbm_bw
    coll_s = collective_bytes / hw.link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    out = {**terms, "dominant": dominant, "bound_s": bound, "chips": chips}
    if model_flops is not None and hlo_flops:
        out["model_flops"] = model_flops
        out["useful_flops_ratio"] = model_flops / (hlo_flops * chips)
        # roofline fraction: useful model FLOPs per chip over what the
        # dominant term allows
        out["roofline_frac"] = (model_flops / chips / hw.peak_flops) / bound
    return out


def collective_terms(coll_by_axis: dict, hw: HW = HW()) -> dict:
    """Seconds of each mesh axis's collective operand bytes
    (``roofline/trace.py``'s ``coll_by_axis``): the ``"pod"`` axis,
    which spans hosts, at ``dcn_bw``, every other axis at ``link_bw``;
    and their sum."""
    out = {axis: sum(by.values()) / (hw.dcn_bw if axis == "pod"
                                     else hw.link_bw)
           for axis, by in coll_by_axis.items()}
    return {"by_axis_s": out, "collective_s": sum(out.values())}


def model_flops_estimate(cfg, shape, *, mode: str) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode: D=B tokens."""
    n_active = cfg.param_count(active_only=True)
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence per step
    return 2.0 * n_active * shape.global_batch
