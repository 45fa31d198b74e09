"""Forward-sweep kernels: plain versions, CUDA kernels, dispatch."""
from repro_torch.kernels.sweep.ops import (level_arrivals,  # noqa: F401
                                           wait_propagate)
from repro_torch.kernels.sweep.ref import arrivals_ref, wait_ref  # noqa: F401
from repro_torch.kernels.sweep.sweep import (arrivals_cuda,  # noqa: F401
                                             wait_cuda)
