// A no-op device guard for CUDA, for a torch built without CUDA.
//
// Fake CUDA tensors (FakeTensorMode) hold no memory and run no kernel,
// but PyTorch's C++ side still asks for the CUDA device guard where it
// indexes a tensor or records an autograd node, and a build without
// CUDA has none to give.  Registering c10's NoOpDeviceGuardImpl for
// CUDA lets such a build trace a forward on fake CUDA tensors.  Loaded
// only where torch has no CUDA (roofline/fake_cuda.py).
#include <c10/core/impl/DeviceGuardImplInterface.h>

namespace {
c10::impl::NoOpDeviceGuardImpl<c10::DeviceType::CUDA> guard;
}

extern "C" int repro_register_fake_cuda_guard() {
  c10::impl::device_guard_impl_registry[static_cast<size_t>(
      c10::DeviceType::CUDA)].store(&guard);
  return 0;
}
