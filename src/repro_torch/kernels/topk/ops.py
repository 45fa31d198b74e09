"""Public entry of the local top-k: the kernel on the card, the plain
version on the CPU (mirrors ``merge/ops.py``)."""
from __future__ import annotations

from repro_torch.kernels.topk.ref import topk_ref
from repro_torch.kernels.topk.topk import topk_cuda


def local_topk(scores, k: int, *, index_offset: int = 0):
    """Top-k (f32 values, int32 global indices) of ``scores`` along the
    last axis.

    The paper's Local Query Execution: score local items, keep the k
    best couples.  ``index_offset`` turns local positions into global
    addresses.  A CPU tensor goes to the plain version (``topk_ref``), a
    CUDA tensor to the CUDA kernel (``topk_cuda``, which raises on what
    it does not take); there is no fallback between the two.
    """
    kind = scores.device.type
    if kind == "cpu":
        return topk_ref(scores, k, index_offset=index_offset)
    if kind == "cuda":
        return topk_cuda(scores, k, index_offset=index_offset)
    raise ValueError(f"local_topk: no path for {kind} tensors")
