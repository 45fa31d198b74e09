"""Score-list merge: plain version, CUDA kernel and their dispatch."""
from repro_torch.kernels.merge.merge import merge_cuda  # noqa: F401
from repro_torch.kernels.merge.ops import merge_scorelists  # noqa: F401
from repro_torch.kernels.merge.ref import merge_ref  # noqa: F401
