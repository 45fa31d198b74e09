// Score-list merge (Merge-and-Backward phase) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/merge/merge.py::merge_pallas (body
// _merge_kernel, network _bitonic_descending): the top-k of the union of
// two descending k-lists of (score, owner) couples, with optional
// per-row validity masks that turn a whole list into -inf.
//
// Bound: device-memory bytes.  Each output element costs one compare
// per step of a binary search over a k-row held in shared memory
// (log2(k) + 1 compares) against 12 bytes moved per element in f64;
// at the sweep's K = 32 the card's compare rate is far above what its
// memory bandwidth can feed.
//
// Design: merge by rank instead of the TPU kernel's bitonic network.
// Both inputs are sorted descending in the total order of Num<T>::key
// (the sweep's own lists come from the order-statistics draw padded with
// -inf tails, the collectives' from the top-k kernel, and every merge
// preserves the order), so one thread per input element can compute its
// output position directly (comparisons are of keys):
//   a[j] goes to j + #{b > a[j]},   b[l] goes to l + #{a >= b[l]},
// each count a binary search over the other row in shared memory, and a
// thread writes its element only when that position is < k.  This is
// exactly the stable tie rule of the plain version (list a first, then
// the lower position), uses compare and select only (f64 stays
// bit-exact), reads every input element once with neighbouring threads
// on neighbouring addresses, and writes each output element once.
// Several rows share a block so a block holds at least 128 threads.
//
// Inputs and outputs are (rows, k) contiguous; owners int32; masks are
// one byte per row (nullptr = all valid).  Launch counter:
// repro_torch.kernels._build.LAUNCHES["merge"].
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
struct Num;

// Keys are integers of the value's bits whose order is the IEEE total
// order that the reference's lax.top_k ranks by (+NaN > +inf > ... >
// +0.0 > -0.0 > ... > -inf > -NaN): flipping the magnitude bits of a
// negative value turns sign-magnitude into two's-complement order.  The
// plain version sorts on the same key (repro_torch/kernels/order.py).
template <>
struct Num<double> {
  using Key = long long;
  __device__ static Key key(double x) {
    const long long b = __double_as_longlong(x);
    return b ^ ((b >> 63) & 0x7fffffffffffffffLL);
  }
  __device__ static double neg_inf() { return -__longlong_as_double(0x7ff0000000000000LL); }
};

template <>
struct Num<float> {
  using Key = int;
  __device__ static Key key(float x) {
    const int b = __float_as_int(x);
    return b ^ ((b >> 31) & 0x7fffffff);
  }
  __device__ static float neg_inf() { return -__int_as_float(0x7f800000); }
};

template <>
struct Num<__nv_bfloat16> {
  // the 16 bits, sign-extended to int, then the same flip
  using Key = int;
  __device__ static Key key(__nv_bfloat16 x) {
    const int b = static_cast<short>(__bfloat16_as_ushort(x));
    return b ^ ((b >> 31) & 0x7fffffff);
  }
  __device__ static __nv_bfloat16 neg_inf() {
    return __ushort_as_bfloat16(static_cast<unsigned short>(0xFF80U));
  }
};

template <typename T>
__global__ void merge_kernel(const T* __restrict__ va,
                             const int32_t* __restrict__ ia,
                             const T* __restrict__ vb,
                             const int32_t* __restrict__ ib,
                             const uint8_t* __restrict__ ma,
                             const uint8_t* __restrict__ mb,
                             T* __restrict__ vo, int32_t* __restrict__ io,
                             long long rows, int k, int rows_per_block) {
  using Key = typename Num<T>::Key;
  extern __shared__ __align__(16) unsigned char smem[];
  Key* keys = reinterpret_cast<Key*>(smem);
  const int per_row = 2 * k;
  const int local = threadIdx.x / per_row;
  const int t = threadIdx.x - local * per_row;
  const long long row = static_cast<long long>(blockIdx.x) * rows_per_block + local;
  const bool active = row < rows;
  const bool from_a = t < k;
  const int j = from_a ? t : t - k;
  Key* ka = keys + static_cast<size_t>(local) * per_row;
  Key* kb = ka + k;
  const long long off = row * k;

  T x{};
  int32_t owner = 0;
  if (active) {
    const uint8_t* mask = from_a ? ma : mb;
    x = from_a ? va[off + j] : vb[off + j];
    owner = from_a ? ia[off + j] : ib[off + j];
    if (mask != nullptr && mask[row] == 0) x = Num<T>::neg_inf();
    (from_a ? ka : kb)[j] = Num<T>::key(x);
  }
  __syncthreads();
  if (!active) return;

  const Key xk = Num<T>::key(x);
  int lo = 0;
  int hi = k;
  if (from_a) {
    // #{b > x}: b is non-increasing, so it is the first l with b[l] <= x
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (kb[mid] > xk) lo = mid + 1; else hi = mid;
    }
  } else {
    // #{a >= x}: the first j with a[j] < x
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ka[mid] >= xk) lo = mid + 1; else hi = mid;
    }
  }
  const int pos = j + lo;
  if (pos < k) {
    vo[off + pos] = x;
    io[off + pos] = owner;
  }
}

template <typename T>
int launch_merge(const void* va, const void* ia, const void* vb,
                 const void* ib, const void* ma, const void* mb, void* vo,
                 void* io, long long rows, int k, void* stream) {
  if (rows <= 0) return 0;
  if (k < 1 || k > 512) return static_cast<int>(cudaErrorInvalidValue);
  const int per_row = 2 * k;
  const int rows_per_block = per_row >= 256 ? 1 : 256 / per_row;
  const int threads = rows_per_block * per_row;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = static_cast<size_t>(threads) * sizeof(typename Num<T>::Key);
  merge_kernel<T><<<static_cast<unsigned>(blocks), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(va), static_cast<const int32_t*>(ia),
      static_cast<const T*>(vb), static_cast<const int32_t*>(ib),
      static_cast<const uint8_t*>(ma), static_cast<const uint8_t*>(mb),
      static_cast<T*>(vo), static_cast<int32_t*>(io), rows, k,
      rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_MERGE_LAUNCHER(NAME, T)                                      \
  extern "C" int NAME(const void* va, const void* ia, const void* vb,      \
                      const void* ib, const void* ma, const void* mb,      \
                      void* vo, void* io, long long rows, int k,           \
                      void* stream) {                                      \
    return launch_merge<T>(va, ia, vb, ib, ma, mb, vo, io, rows, k,        \
                           stream);                                        \
  }

REPRO_MERGE_LAUNCHER(repro_merge_f64, double)
REPRO_MERGE_LAUNCHER(repro_merge_f32, float)
REPRO_MERGE_LAUNCHER(repro_merge_bf16, __nv_bfloat16)
