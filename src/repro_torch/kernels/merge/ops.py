"""Public entry of the score-list merge: the kernel on the card, the
plain version on the CPU."""
from __future__ import annotations

from repro_torch.kernels.merge.merge import merge_cuda
from repro_torch.kernels.merge.ref import merge_ref


def merge_scorelists(vals_a, idx_a, vals_b, idx_b, *, valid_a=None,
                     valid_b=None):
    """Merge-and-Backward: top-k of the union of two descending k-lists.

    A CPU tensor goes to the plain version (``merge_ref``), a CUDA
    tensor to the CUDA kernel (``merge_cuda``, which raises on what it
    does not take); there is no fallback between the two.  Inputs must
    be sorted descending — see ``merge_cuda``.
    """
    kind = vals_a.device.type
    if kind == "cpu":
        return merge_ref(vals_a, idx_a, vals_b, idx_b,
                         valid_a=valid_a, valid_b=valid_b)
    if kind == "cuda":
        return merge_cuda(vals_a, idx_a, vals_b, idx_b,
                          valid_a=valid_a, valid_b=valid_b)
    raise ValueError(f"merge_scorelists: no path for {kind} tensors")
