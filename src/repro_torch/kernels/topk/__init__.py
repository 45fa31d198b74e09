"""Local top-k: plain version, CUDA kernel and their dispatch."""
from repro_torch.kernels.topk.ops import local_topk  # noqa: F401
from repro_torch.kernels.topk.ref import topk_ref  # noqa: F401
from repro_torch.kernels.topk.topk import topk_cuda  # noqa: F401
