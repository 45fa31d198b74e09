// Per-depth forward-sweep kernels for Hopper (sm_90a): level arrivals
// and the Appendix-A wait rule.
//
// arrivals replaces src/repro/kernels/sweep/sweep.py::arrivals_pallas
// (body _arrivals_kernel): out[e, l] = tq_prev[e, par_pos[l]] + dn[e, l].
// wait replaces src/repro/kernels/sweep/sweep.py::wait_pallas (bodies
// _wait_kernel and _wait_churn_kernel):
//   s = min(max(own, all_in), max(deadline, own)),
// and the churn variant also writes send = (death >= s) ? s : inf in the
// same pass.
//
// Bound: device-memory bytes.  Both do one add or four compares per
// element against 24 to 40 bytes moved per element in f64.
//
// Design: one thread per output element (grid-stride), l fastest, so
// loads of dn / own / all_in / deadline and every store coalesce; the
// only irregular read is the arrivals gather of the parent level's row,
// which stays inside one entry's row of the (small) parent level and is
// served by L2.  The churn variant writes s and send from one read of
// its inputs.  Float grouping is exactly the plain version's, and bf16
// adds in float and rounds once, as torch does, so every dtype is
// bit-equal to the plain version.
//
// Launch counters: repro_torch.kernels._build.LAUNCHES["arrivals"],
// ["wait"] and ["wait_churn"].
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
struct Num;

template <>
struct Num<double> {
  __device__ static double key(double x) { return x; }
  __device__ static double add(double a, double b) { return a + b; }
  __device__ static double inf() { return __longlong_as_double(0x7ff0000000000000LL); }
};

template <>
struct Num<float> {
  __device__ static float key(float x) { return x; }
  __device__ static float add(float a, float b) { return a + b; }
  __device__ static float inf() { return __int_as_float(0x7f800000); }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float key(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  __device__ static __nv_bfloat16 inf() {
    return __ushort_as_bfloat16(static_cast<unsigned short>(0x7F80U));
  }
};

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return Num<T>::key(a) < Num<T>::key(b) ? b : a;
}

template <typename T>
__device__ __forceinline__ T vmin(T a, T b) {
  return Num<T>::key(b) < Num<T>::key(a) ? b : a;
}

constexpr int kThreads = 256;

long long grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return blocks < (1LL << 20) ? blocks : (1LL << 20);
}

template <typename T, typename I>
__global__ void arrivals_kernel(const T* __restrict__ tq_prev,
                                const T* __restrict__ dn,
                                const I* __restrict__ par_pos,
                                T* __restrict__ out, long long E,
                                long long L, long long Lp) {
  const long long total = E * L;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long e = i / L;
    const long long l = i - e * L;
    out[i] = Num<T>::add(tq_prev[e * Lp + static_cast<long long>(par_pos[l])],
                         dn[i]);
  }
}

template <typename T>
__global__ void wait_kernel(const T* __restrict__ own,
                            const T* __restrict__ all_in,
                            const T* __restrict__ deadline,
                            T* __restrict__ s_out, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const T o = own[i];
    s_out[i] = vmin(vmax(o, all_in[i]), vmax(deadline[i], o));
  }
}

template <typename T>
__global__ void wait_churn_kernel(const T* __restrict__ own,
                                  const T* __restrict__ all_in,
                                  const T* __restrict__ deadline,
                                  const T* __restrict__ death,
                                  T* __restrict__ s_out,
                                  T* __restrict__ send_out, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const T o = own[i];
    const T s = vmin(vmax(o, all_in[i]), vmax(deadline[i], o));
    s_out[i] = s;
    // dead at send time -> an arrival that can never release a parent
    send_out[i] = Num<T>::key(death[i]) >= Num<T>::key(s) ? s : Num<T>::inf();
  }
}

template <typename T, typename I>
int launch_arrivals(const void* tq_prev, const void* dn, const void* par_pos,
                    void* out, long long E, long long L, long long Lp,
                    void* stream) {
  const long long total = E * L;
  if (total <= 0) return 0;
  arrivals_kernel<T, I><<<static_cast<unsigned>(grid_for(total)), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tq_prev), static_cast<const T*>(dn),
      static_cast<const I*>(par_pos), static_cast<T*>(out), E, L, Lp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wait(const void* own, const void* all_in, const void* deadline,
                void* s_out, long long total, void* stream) {
  if (total <= 0) return 0;
  wait_kernel<T><<<static_cast<unsigned>(grid_for(total)), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(own), static_cast<const T*>(all_in),
      static_cast<const T*>(deadline), static_cast<T*>(s_out), total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wait_churn(const void* own, const void* all_in,
                      const void* deadline, const void* death, void* s_out,
                      void* send_out, long long total, void* stream) {
  if (total <= 0) return 0;
  wait_churn_kernel<T><<<static_cast<unsigned>(grid_for(total)), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(own), static_cast<const T*>(all_in),
      static_cast<const T*>(deadline), static_cast<const T*>(death),
      static_cast<T*>(s_out), static_cast<T*>(send_out), total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_ARRIVALS_LAUNCHER(NAME, T, I)                                 \
  extern "C" int NAME(const void* tq_prev, const void* dn,                  \
                      const void* par_pos, void* out, long long E,          \
                      long long L, long long Lp, void* stream) {            \
    return launch_arrivals<T, I>(tq_prev, dn, par_pos, out, E, L, Lp,       \
                                 stream);                                   \
  }

#define REPRO_WAIT_LAUNCHERS(SUFFIX, T)                                     \
  extern "C" int repro_wait_##SUFFIX(const void* own, const void* all_in,   \
                                     const void* deadline, void* s_out,     \
                                     long long total, void* stream) {       \
    return launch_wait<T>(own, all_in, deadline, s_out, total, stream);     \
  }                                                                         \
  extern "C" int repro_wait_churn_##SUFFIX(                                 \
      const void* own, const void* all_in, const void* deadline,            \
      const void* death, void* s_out, void* send_out, long long total,      \
      void* stream) {                                                       \
    return launch_wait_churn<T>(own, all_in, deadline, death, s_out,        \
                                send_out, total, stream);                   \
  }

REPRO_ARRIVALS_LAUNCHER(repro_arrivals_f64_i32, double, int32_t)
REPRO_ARRIVALS_LAUNCHER(repro_arrivals_f64_i64, double, int64_t)
REPRO_ARRIVALS_LAUNCHER(repro_arrivals_f32_i32, float, int32_t)
REPRO_ARRIVALS_LAUNCHER(repro_arrivals_f32_i64, float, int64_t)
REPRO_ARRIVALS_LAUNCHER(repro_arrivals_bf16_i32, __nv_bfloat16, int32_t)
REPRO_ARRIVALS_LAUNCHER(repro_arrivals_bf16_i64, __nv_bfloat16, int64_t)

REPRO_WAIT_LAUNCHERS(f64, double)
REPRO_WAIT_LAUNCHERS(f32, float)
REPRO_WAIT_LAUNCHERS(bf16, __nv_bfloat16)
