// Local top-k (Local Query Execution phase) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/topk/topk.py::topk_pallas (body
// _topk_kernel, extraction _extract_topk): the k largest scores of each
// row with their int32 global indices (local index + index_offset),
// descending, compared as f32 whatever the input type (f32, bf16, f16
// are read natively and widened exactly, NaNs included).  It computes
// what the reference's topk_ref computes: lax.top_k's order, the IEEE
// total order of the f32 bits (+NaN > +inf > ... > +0.0 > -0.0 > ... >
// -inf > -NaN), ties to the lowest index.  Unlike topk_pallas, a -inf
// element keeps its real index (topk_pallas reports -1 for it).
//
// Bound: device-memory bytes.  Every input element is read once and
// costs one pack (a few integer operations) and, per extraction round,
// at most one compare in its thread; rows * n * elt + rows * k * 8
// bytes over 3.35 TB/s is the bound.
//
// Design.  Each element becomes one 64-bit word
//     (total-order key of its f32 bits) << 32 | (0xffffffff - local index)
// so that a larger word is a larger score, or an equal score at a lower
// index: every word of a row is distinct and "top-k with lowest-index
// ties" is the k largest words.  0 marks an empty slot; no real word is
// 0 (local indices are < 2^31), so a real -inf element beats it.
//   pass 1: grid (rows x tiles).  A block of 256 threads holds one tile
//     of CHUNK - k elements, 16 words a thread in registers, and runs k
//     rounds of a block argmax: each thread offers its best word, a warp
//     shuffle and one shared-memory exchange find the block's maximum,
//     and the one thread that owns it drops it and rescans its 16
//     words.  The k winners of each tile go to scratch (or straight to
//     the output when the row is one tile).
//   pass 2: one block per row reduces the tiles * k candidates the same
//     way, CHUNK - k new words at a time beside the running k-list.
// The global index of every word makes "lowest index wins" hold across
// tiles, which the TPU kernel gets from its sequential grid instead.
//
// Launch counter: repro_torch.kernels._build.LAUNCHES["topk"].
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 16;                  // words per thread per chunk
constexpr int CHUNK = THREADS * PER;     // words a block holds at once
constexpr int MAX_K = 256;

// Exact widening by bits, NaNs keeping sign and payload as the
// reference's astype(float32) does (the plain version's to_f32)
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(x)) << 16);
}
__device__ __forceinline__ float to_f32(__half x) {
  const unsigned h = __half_as_ushort(x);
  if ((h & 0x7c00u) == 0x7c00u && (h & 0x3ffu) != 0u)      // NaN
    return __uint_as_float(((h & 0x8000u) << 16) | 0x7f800000u |
                           ((h & 0x3ffu) << 13));
  return __half2float(x);
}

// total-order key of the f32 bits, offset so that it orders as unsigned
__device__ __forceinline__ unsigned key_of(float x) {
  int b = __float_as_int(x);
  b ^= (b >> 31) & 0x7fffffff;
  return static_cast<unsigned>(b) ^ 0x80000000u;
}

// the inverse of key_of (the flip is its own inverse)
__device__ __forceinline__ float value_of(unsigned key) {
  int b = static_cast<int>(key ^ 0x80000000u);
  b ^= (b >> 31) & 0x7fffffff;
  return __int_as_float(b);
}

__device__ __forceinline__ u64 pack(float x, long long local) {
  return (static_cast<u64>(key_of(x)) << 32) |
         static_cast<u64>(0xffffffffu - static_cast<unsigned>(local));
}

__device__ __forceinline__ u64 wmax(u64 a, u64 b) { return a > b ? a : b; }

// one row's scores [lo, lo + count) as words
template <typename T>
struct ScoreWords {
  const T* row;
  long long lo;
  __device__ u64 operator()(long long e) const {
    return pack(to_f32(row[lo + e]), lo + e);
  }
};

// one row's candidate words from pass 1
struct CandidateWords {
  const u64* row;
  __device__ u64 operator()(long long e) const { return row[e]; }
};

// The k largest of the running list res[0, k) and words [0, count) of
// `load`, descending, into res.  res must hold k words (0 = empty) and
// every thread of the block must call this.
template <typename Load>
__device__ void block_topk(const Load& load, long long count, int k,
                           u64* res, u64 (*warp_best)[WARPS]) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int fresh = CHUNK - k;           // new words per chunk
  for (long long done = 0; done < count; done += fresh) {
    u64 v[PER];
    u64 best = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int s = j * THREADS + t;     // neighbouring threads, neighbouring words
      u64 w = 0;
      if (s < k) {
        w = res[s];
      } else {
        const long long e = done + (s - k);
        if (e < count) w = load(e);
      }
      v[j] = w;
      best = wmax(best, w);
    }
    for (int r = 0; r < k; ++r) {
      u64 m = best;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = wmax(m, __shfl_xor_sync(0xffffffffu, m, off));
      // two buffers: round r + 1 writes the other one while slower
      // threads still read this one; round r + 2 comes after a barrier
      if (lane == 0) warp_best[r & 1][warp] = m;
      __syncthreads();                   // also: every thread has read res
#pragma unroll
      for (int w = 0; w < WARPS; ++w) m = wmax(m, warp_best[r & 1][w]);
      if (t == 0) res[r] = m;
      if (m != 0 && best == m) {         // the one thread holding it
        best = 0;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          if (v[j] == m) v[j] = 0;
          best = wmax(best, v[j]);
        }
      }
    }
    __syncthreads();                     // res complete for the next chunk
  }
}

__device__ void write_out(const u64* res, int k, float* vo, int32_t* io,
                          int offset) {
  for (int q = threadIdx.x; q < k; q += THREADS) {
    const u64 w = res[q];
    vo[q] = value_of(static_cast<unsigned>(w >> 32));
    io[q] = static_cast<int32_t>(0xffffffffu - static_cast<unsigned>(w)) +
            offset;
  }
}

__device__ void clear(u64* res, int k) {
  for (int q = threadIdx.x; q < k; q += THREADS) res[q] = 0;
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_tiles(const T* __restrict__ x, long long n, int k, int tiles,
           u64* __restrict__ cand, float* __restrict__ vo,
           int32_t* __restrict__ io, int offset) {
  __shared__ u64 res[MAX_K];
  __shared__ u64 warp_best[2][WARPS];
  const long long row = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x - row * tiles);
  const long long width = CHUNK - k;
  const long long lo = tile * width;
  const long long count = n - lo < width ? n - lo : width;
  clear(res, k);
  block_topk(ScoreWords<T>{x + row * n, lo}, count, k, res, warp_best);
  if (tiles == 1) {
    write_out(res, k, vo + row * k, io + row * k, offset);
  } else {
    u64* out = cand + (row * tiles + tile) * k;
    for (int q = threadIdx.x; q < k; q += THREADS) out[q] = res[q];
  }
}

__global__ void __launch_bounds__(THREADS)
topk_final(const u64* __restrict__ cand, long long m, int k,
           float* __restrict__ vo, int32_t* __restrict__ io, int offset) {
  __shared__ u64 res[MAX_K];
  __shared__ u64 warp_best[2][WARPS];
  const long long row = blockIdx.x;
  clear(res, k);
  block_topk(CandidateWords{cand + row * m}, m, k, res, warp_best);
  write_out(res, k, vo + row * k, io + row * k, offset);
}

long long n_tiles(long long n, int k) {
  const long long width = CHUNK - k;
  return (n + width - 1) / width;
}

template <typename T>
int launch_topk(const void* x, long long rows, long long n, int k,
                int offset, void* cand, void* vo, void* io, void* stream) {
  if (rows <= 0) return 0;
  if (k < 1 || k > MAX_K || n < k || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = n_tiles(n, k);
  if (rows * tiles > 0x7fffffffLL || (tiles > 1 && cand == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  topk_tiles<T><<<static_cast<unsigned>(rows * tiles), THREADS, 0, s>>>(
      static_cast<const T*>(x), n, k, static_cast<int>(tiles),
      static_cast<u64*>(cand), static_cast<float*>(vo),
      static_cast<int32_t*>(io), offset);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  topk_final<<<static_cast<unsigned>(rows), THREADS, 0, s>>>(
      static_cast<const u64*>(cand), tiles * k, k, static_cast<float*>(vo),
      static_cast<int32_t*>(io), offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words of pass-1 scratch per row (0 when the row is one tile)
extern "C" long long repro_topk_scratch(long long n, int k) {
  if (k < 1 || k > MAX_K) return -1;
  const long long tiles = n_tiles(n, k);
  return tiles > 1 ? tiles * k : 0;
}

#define REPRO_TOPK_LAUNCHER(NAME, T)                                       \
  extern "C" int NAME(const void* x, long long rows, long long n, int k,   \
                      int offset, void* cand, void* vo, void* io,          \
                      void* stream) {                                      \
    return launch_topk<T>(x, rows, n, k, offset, cand, vo, io, stream);    \
  }

REPRO_TOPK_LAUNCHER(repro_topk_f32, float)
REPRO_TOPK_LAUNCHER(repro_topk_bf16, __nv_bfloat16)
REPRO_TOPK_LAUNCHER(repro_topk_f16, __half)
