"""Local top-k: plain version, CUDA kernel, their dispatch, and the
dispatch with ``lax.top_k``'s gradient."""
from repro_torch.kernels.topk.ops import (  # noqa: F401
    local_topk, topk_with_grad)
from repro_torch.kernels.topk.ref import topk_ref  # noqa: F401
from repro_torch.kernels.topk.topk import topk_cuda  # noqa: F401
