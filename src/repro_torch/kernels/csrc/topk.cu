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
// Bound: device-memory bytes.  rows * n * elt + rows * k * 8 bytes over
// 3.35 TB/s; an element costs a handful of integer operations.  The
// TPU kernel's k rounds of (max, first argmax, mask) over a tile would
// put k dependent block barriers on every tile here, so the design
// reads each score once and selects by counting instead:
//
//   pass 1, one block of 512 threads per tile of TILE scores (a row of
//     up to TILE scores is one tile; two blocks share an SM).  The block
//     streams its tile from device memory once, in 16-byte loads, four
//     in flight a thread, turns each score into its 32-bit total-order
//     key, stages the key in shared memory and counts its top 12 bits
//     into a 4096-bin histogram as it arrives.  A block scan of the
//     histogram gives the bin that holds the k-th largest key.  The
//     threads that own a key reaching that bin look at their keys
//     again: every key above the bin is a winner, and the bin's keys (a
//     few dozen for normal scores) are gathered as 64-bit words; the
//     rest are the largest of those words, by rank (each counts the
//     words above it) when there are at most 512, else by a radix
//     select one byte at a time.  A tile whose bin holds more than CAND
//     keys (heavy ties) selects over the whole staged tile instead, one
//     byte at a time, and cuts the last tie by a block prefix count in
//     index order.  A warp whose lanes all count one bin adds once, so
//     an input of one repeated value does not serialise on a counter.
//     What is left above the bound is the selection's latency: while a
//     block selects, only the other block on its SM loads.
//   pass 2, only when a row has several tiles: one block per row
//     selects the k largest of the row's tiles * k candidate words the
//     same way, staged in shared memory when they fit.
// A winner travels as one 64-bit word
//     (total-order key) << 32 | (0xffffffff - local index),
// so a larger word is a larger score or an equal score at a lower
// index: the words of a row are distinct and the lowest-index rule
// holds across tiles.  0 marks an empty candidate slot (a last tile of
// fewer than k scores); no real word is 0 (local indices are < 2^31).
// The winners are sorted by rank (each counts the words above it).
//
// The wrapper (kernels/topk/topk.py) computes the tiles and the scratch
// size from TILE and passes them in; the launcher refuses other values.
//
// Launch counter: repro_torch.kernels._build.LAUNCHES["topk"].
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int FIRST_BITS = 12;          // the first digit: 4096 bins
constexpr int FIRST_BINS = 1 << FIRST_BITS;
constexpr int BINS = 256;               // a later digit: one byte
constexpr int TILE = 20480;             // scores a pass-1 block holds
constexpr int CAND = 1536;              // k-th bin keys a block gathers
constexpr int STAGE = 8192;             // candidate words pass 2 stages
constexpr int UNROLL = 4;               // 16-byte loads in flight a thread
constexpr int MAX_K = 256;
constexpr unsigned FULL = 0xffffffffu;
static_assert(FIRST_BINS == 8 * THREADS, "a thread scans 8 first bins");

// Exact widening by bits, NaNs keeping sign and payload as the
// reference's astype(float32) does (the plain version's to_f32)
__device__ __forceinline__ unsigned f32_bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned f32_bits(__nv_bfloat16 x) {
  return static_cast<unsigned>(__bfloat16_as_ushort(x)) << 16;
}
__device__ __forceinline__ unsigned f32_bits(__half x) {
  const unsigned h = __half_as_ushort(x);
  if ((h & 0x7c00u) == 0x7c00u && (h & 0x3ffu) != 0u)      // NaN
    return ((h & 0x8000u) << 16) | 0x7f800000u | ((h & 0x3ffu) << 13);
  return __float_as_uint(__half2float(x));
}

// total-order key of f32 bits, offset so that it orders as unsigned
__device__ __forceinline__ unsigned key_of(unsigned bits) {
  int b = static_cast<int>(bits);
  b ^= (b >> 31) & 0x7fffffff;
  return static_cast<unsigned>(b) ^ 0x80000000u;
}

// the inverse of key_of (the flip is its own inverse)
__device__ __forceinline__ float value_of(unsigned key) {
  int b = static_cast<int>(key ^ 0x80000000u);
  b ^= (b >> 31) & 0x7fffffff;
  return __int_as_float(b);
}

__device__ __forceinline__ u64 word_of(unsigned key, long long local) {
  return (static_cast<u64>(key) << 32) |
         static_cast<u64>(0xffffffffu - static_cast<unsigned>(local));
}
__device__ __forceinline__ u64 word_of(u64 word, long long) { return word; }

// The block's shared state; the keys or words it selects from follow.
struct alignas(16) Shared {
  unsigned hist[FIRST_BINS];   // the histogram, kept zeroed
  u64 res[MAX_K];              // the winners, unordered
  u64 out[MAX_K];              // the winners, descending
  unsigned warp_sum[WARPS];
  u64 lo, hi;                  // the bin of the k-th key, [lo, hi]
  int need;                    // keys still wanted from that bin
  int cnt;                     // keys in that bin
  int taken;                   // winners placed so far
  int ncand;                   // bin keys gathered so far
};

// Count `bin` for every lane with ok; every lane of the warp calls
// this.  A warp whose lanes all hold one bin adds once: an input of one
// repeated value would otherwise serialise 32 adds on one counter.
__device__ __forceinline__ void hist_add(unsigned* h, unsigned bin,
                                         bool ok) {
  const unsigned b0 = __shfl_sync(FULL, bin, 0);
  if (__all_sync(FULL, ok && bin == b0)) {
    if ((threadIdx.x & 31) == 0) atomicAdd(&h[b0], 32u);
  } else if (ok) {
    atomicAdd(&h[bin], 1u);
  }
}

// Exclusive prefix sum of x over the block's threads in order.  Every
// thread calls this; warp_sum is free again after the next barrier.
__device__ unsigned block_exclusive(Shared& s, unsigned x) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) s.warp_sum[warp] = inc;
  __syncthreads();
  unsigned before = inc - x;
  for (int w = 0; w < warp; ++w) before += s.warp_sum[w];
  return before;
}

// Narrow [lo, hi] to the bin of the NB-bin digit at `shift` that holds
// the need-th largest key, zeroing the histogram.  Every thread of the
// block calls this; it starts and ends with a barrier.
template <typename U, int NB>
__device__ void pick_bin(Shared& s, int shift) {
  const int t = threadIdx.x;
  __syncthreads();                       // the histogram is complete
  const unsigned need = static_cast<unsigned>(s.need);
  // thread t holds the 8 bins below NB - 8t, read and zeroed as two
  // 16-byte words: the top bins first, and no bank conflicts
  const bool mine = t < NB / 8;
  unsigned v[8] = {};
  if (mine) {
    uint4* p = reinterpret_cast<uint4*>(s.hist + NB - 8 * (t + 1));
    const uint4 a = p[0], b = p[1];
    p[0] = p[1] = make_uint4(0u, 0u, 0u, 0u);
    v[0] = b.w; v[1] = b.z; v[2] = b.y; v[3] = b.x;
    v[4] = a.w; v[5] = a.z; v[6] = a.y; v[7] = a.x;
  }
  unsigned tot = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) tot += v[j];
  unsigned above = block_exclusive(s, tot);  // keys in higher bins
  if (mine) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (above < need && above + v[j] >= need) {
        const U lo = static_cast<U>(s.lo) |
                     (static_cast<U>(NB - 1 - 8 * t - j) << shift);
        s.lo = lo;
        s.hi = lo | ((static_cast<U>(1) << shift) - 1);
        s.need = static_cast<int>(need - above);
        s.cnt = static_cast<int>(v[j]);
      }
      above += v[j];
    }
  }
  __syncthreads();
}

// Refine [lo, hi] over src[0, count) one byte at a time from `shift`
// down (the last digit clamped to bit 0), until the bin holds exactly
// the keys still wanted.
template <typename U>
__device__ void refine(Shared& s, const U* src, long long count,
                       int shift) {
  while (s.cnt != s.need) {
    const U lo = static_cast<U>(s.lo), hi = static_cast<U>(s.hi);
    for (long long i0 = 0; i0 < count; i0 += THREADS) {
      const long long i = i0 + threadIdx.x;
      const U key = i < count ? src[i] : U(0);
      hist_add(s.hist, static_cast<unsigned>(key >> shift) & (BINS - 1),
               i < count && key >= lo && key <= hi);
    }
    pick_bin<U, BINS>(s, shift);
    if (shift == 0) break;
    shift = shift > 8 ? shift - 8 : 0;
  }
}

// Place the winners of src[0, count) in res: every key above the bin,
// and the bin's keys (all of them, or the `need` lowest-indexed when
// they are all equal).  Local index = base + i.
template <typename U>
__device__ void collect(Shared& s, const U* src, long long count,
                        long long base) {
  const int t = threadIdx.x;
  const U lo = static_cast<U>(s.lo), hi = static_cast<U>(s.hi);
  const bool all = s.cnt == s.need;
  for (long long i = t; i < count; i += THREADS) {
    const U key = src[i];
    if (key > hi || (all && key >= lo))
      s.res[atomicAdd(&s.taken, 1)] = word_of(key, base + i);
  }
  if (all) {
    __syncthreads();
    return;
  }
  // lo == hi: the need lowest-indexed equal keys, by a block prefix
  // count over contiguous runs of the index
  const long long per = (count + THREADS - 1) / THREADS;
  const long long a = t * per;
  const long long b = a + per < count ? a + per : count;
  unsigned mine = 0;
  for (long long i = a; i < b; ++i) mine += src[i] == lo;
  unsigned before = block_exclusive(s, mine);  // its barrier: all
  const unsigned need = static_cast<unsigned>(s.need);  // adds done
  const int first = s.taken;
  for (long long i = a; i < b && before < need; ++i) {
    if (src[i] == lo) {
      s.res[first + before] = word_of(lo, base + i);
      ++before;
    }
  }
  __syncthreads();
}

// Sort res[0, m) descending into out by rank, then write the k values
// and global indices.
__device__ void write_sorted(Shared& s, int m, float* vo, int32_t* io,
                             int offset) {
  for (int q = threadIdx.x; q < m; q += THREADS) {
    const u64 w = s.res[q];
    int r = 0;
    for (int j = 0; j < m; ++j) r += s.res[j] > w;
    s.out[r] = w;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < m; q += THREADS) {
    const u64 w = s.out[q];
    vo[q] = value_of(static_cast<unsigned>(w >> 32));
    io[q] = static_cast<int32_t>(0xffffffffu - static_cast<unsigned>(w)) +
            offset;
  }
}

__device__ void init(Shared& s, int need, int cnt) {
  for (int i = threadIdx.x; i < FIRST_BINS; i += THREADS) s.hist[i] = 0;
  if (threadIdx.x == 0) {
    s.lo = 0;
    s.hi = ~0ull;
    s.need = need;
    s.cnt = cnt;
    s.taken = 0;
    s.ncand = 0;
  }
  __syncthreads();
}

// f32 bits of a bf16 or f16 given by its 16 bits
__device__ __forceinline__ unsigned bits16(unsigned short u, __nv_bfloat16) {
  return static_cast<unsigned>(u) << 16;
}
__device__ __forceinline__ unsigned bits16(unsigned short u, __half) {
  return f32_bits(__ushort_as_half(u));
}

// keys of 16 bytes of scores, in index order
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void keys(const uint4& v, unsigned* k) {
    k[0] = key_of(v.x); k[1] = key_of(v.y);
    k[2] = key_of(v.z); k[3] = key_of(v.w);
  }
};
template <typename H> struct Vec16 {
  static constexpr int N = 8;
  __device__ static void keys(const uint4& v, unsigned* k) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {      // little-endian: low half first
      k[2 * j] = key_of(bits16(static_cast<unsigned short>(w[j]), H()));
      k[2 * j + 1] =
          key_of(bits16(static_cast<unsigned short>(w[j] >> 16), H()));
    }
  }
};
template <> struct Vec<__nv_bfloat16> : Vec16<__nv_bfloat16> {};
template <> struct Vec<__half> : Vec16<__half> {};

// Pass 1: one block per (row, tile).  Dynamic shared memory: Shared,
// TILE + 4 keys, CAND words.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
topk_tiles(const T* __restrict__ x, long long n, int k, int tiles,
           u64* __restrict__ cand, float* __restrict__ vo,
           int32_t* __restrict__ io, int offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  unsigned* keys = reinterpret_cast<unsigned*>(smem + sizeof(Shared));
  u64* bin_words = reinterpret_cast<u64*>(keys + TILE + 4);
  constexpr int V = Vec<T>::N;
  const int t = threadIdx.x;
  const long long row = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x - row * tiles);
  const long long lo = static_cast<long long>(tile) * TILE;
  const int count = static_cast<int>(n - lo < TILE ? n - lo : TILE);
  const int kt = k < count ? k : count;
  const T* g = x + row * n + lo;
  init(s, kt, count);

  // Load: element e lands in slot e + sh, so that the 16-byte-aligned
  // body of the tile lands on 16-byte-aligned slots; the first digit is
  // counted as the keys arrive.
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15u);
  int head = static_cast<int>(((16 - mis) & 15) / sizeof(T));
  head = head < count ? head : count;
  const int sh = (4 - (head & 3)) & 3;
  const int nvec = (count - head) / V;
  const int tail = count - head - nvec * V;
  unsigned* slot = keys + sh;
  const uint4* body = reinterpret_cast<const uint4*>(g + head);
  // thread t owns vectors t, t + THREADS, ... and at most one element of
  // the unaligned head or tail; kmax is the largest key it owns
  unsigned kmax = 0;
  for (int v0 = 0; v0 < nvec; v0 += THREADS * UNROLL) {
    uint4 buf[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS + t;
      if (v < nvec) buf[u] = __ldcs(body + v);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS + t;
      const bool ok = v < nvec;
      unsigned kk[V];
      if (ok) {
        Vec<T>::keys(buf[u], kk);
        uint4* dst = reinterpret_cast<uint4*>(slot + head + v * V);
#pragma unroll
        for (int j = 0; j < V / 4; ++j)
          dst[j] = make_uint4(kk[4 * j], kk[4 * j + 1], kk[4 * j + 2],
                              kk[4 * j + 3]);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (ok) kmax = kmax > kk[j] ? kmax : kk[j];
        hist_add(s.hist, ok ? kk[j] >> (32 - FIRST_BITS) : 0u, ok);
      }
    }
  }
  // the unaligned head and tail (fewer than 16 bytes each)
  int own = -1;
  if (t < head) own = t;
  else if (t - head < tail) own = head + nvec * V + (t - head);
  {
    unsigned key = 0;
    if (own >= 0) {
      key = key_of(f32_bits(g[own]));
      slot[own] = key;
      kmax = kmax > key ? kmax : key;
    }
    hist_add(s.hist, key >> (32 - FIRST_BITS), own >= 0);
  }

  // Select: the first digit's bin; then, when it holds few keys, those
  // keys as words (distinct, so no tie is left), else the whole tile
  if (kt < count) pick_bin<unsigned, FIRST_BINS>(s, 32 - FIRST_BITS);
  else __syncthreads();                  // keys staged; take them all
  const bool all = s.cnt == s.need;
  if (all || s.cnt <= CAND) {
    // each thread looks again at its own keys, when it owns one that
    // reaches the bin (a few threads of the block, for normal scores)
    const unsigned klo = static_cast<unsigned>(s.lo);
    const unsigned khi = static_cast<unsigned>(s.hi);
    auto take = [&](unsigned key, int e) {
      if (key < klo) return;
      const u64 w = word_of(key, lo + e);
      if (all || key > khi) s.res[atomicAdd(&s.taken, 1)] = w;
      else bin_words[atomicAdd(&s.ncand, 1)] = w;
    };
    if (kmax >= klo) {
      for (int v = t; v < nvec; v += THREADS) {
        const int e = head + v * V;
        const uint4* p = reinterpret_cast<const uint4*>(slot + e);
#pragma unroll
        for (int j = 0; j < V / 4; ++j) {
          const uint4 w4 = p[j];
          take(w4.x, e + 4 * j);
          take(w4.y, e + 4 * j + 1);
          take(w4.z, e + 4 * j + 2);
          take(w4.w, e + 4 * j + 3);
        }
      }
      if (own >= 0) take(slot[own], own);
    }
    __syncthreads();
    if (!all) {
      const int nb = s.cnt;              // refine narrows s.cnt
      if (nb <= THREADS) {
        // by rank: a word wins when fewer than need words beat it
        if (t < nb) {
          const u64 w = bin_words[t];
          int r = 0;
          for (int j = 0; j < nb; ++j) r += bin_words[j] > w;
          if (r < s.need) s.res[s.taken + r] = w;
        }
        __syncthreads();
      } else {
        if (t == 0) {                    // the bin, as words
          s.lo = static_cast<u64>(klo) << 32;
          s.hi = (static_cast<u64>(khi) << 32) | 0xffffffffull;
        }
        __syncthreads();
        refine<u64>(s, bin_words, nb, 64 - FIRST_BITS - 8);
        collect<u64>(s, bin_words, nb, 0);
      }
    }
  } else {
    refine<unsigned>(s, slot, count, 32 - FIRST_BITS - 8);
    collect<unsigned>(s, slot, count, lo);
  }

  if (tiles == 1) {
    write_sorted(s, k, vo + row * k, io + row * k, offset);
  } else {
    u64* out = cand + (row * tiles + tile) * k;
    for (int q = t; q < k; q += THREADS) out[q] = q < kt ? s.res[q] : 0ull;
  }
}

// Pass 2: one block per row over its m = tiles * k candidate words.
// Dynamic shared memory: Shared, then STAGE words when m <= STAGE.
__global__ void __launch_bounds__(THREADS)
topk_final(const u64* __restrict__ cand, long long m, int k,
           float* __restrict__ vo, int32_t* __restrict__ io, int offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  const long long row = blockIdx.x;
  const u64* src = cand + row * m;
  init(s, k, static_cast<int>(m < 0x7fffffffLL ? m : 0x7fffffffLL));
  if (m <= STAGE) {
    u64* staged = reinterpret_cast<u64*>(smem + sizeof(Shared));
    for (long long i = threadIdx.x; i < m; i += THREADS) staged[i] = src[i];
    __syncthreads();
    src = staged;
  }
  // the words are distinct and at least k are real, so the bin of the
  // k-th word narrows to that one word at the latest
  refine<u64>(s, src, m, 56);
  collect<u64>(s, src, m, 0);
  write_sorted(s, k, vo + row * k, io + row * k, offset);
}

constexpr size_t SMEM_TILES = sizeof(Shared) +
                              (TILE + 4) * sizeof(unsigned) +
                              CAND * sizeof(u64);
constexpr size_t SMEM_FINAL = sizeof(Shared) + STAGE * sizeof(u64);
// two pass-1 blocks share an SM (228 KB, 1 KB reserved a block)
static_assert(2 * (SMEM_TILES + 1024) <= 228 * 1024, "2 blocks an SM");

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  // once per kernel and device (the attribute lives in the context)
  static int done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) done[dev] = 1;
  return err;
}

template <typename T>
int launch_topk(const void* x, long long rows, long long n, int k,
                int offset, long long tiles, void* cand, void* vo, void* io,
                void* stream) {
  if (rows <= 0) return 0;
  if (k < 1 || k > MAX_K || n < k || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // the wrapper's plan must be this kernel's: ceil(n / TILE) tiles, and
  // tiles * k words of scratch a row when there are several
  if (tiles != (n + TILE - 1) / TILE || rows * tiles > 0x7fffffffLL ||
      (tiles > 1 && cand == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(topk_tiles<T>, SMEM_TILES);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_tiles<T><<<static_cast<unsigned>(rows * tiles), THREADS, SMEM_TILES,
                  s>>>(static_cast<const T*>(x), n, k,
                       static_cast<int>(tiles), static_cast<u64*>(cand),
                       static_cast<float*>(vo), static_cast<int32_t*>(io),
                       offset);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  const long long m = tiles * k;
  const size_t bytes = m <= STAGE ? SMEM_FINAL : sizeof(Shared);
  err = allow_smem(topk_final, SMEM_FINAL);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_final<<<static_cast<unsigned>(rows), THREADS, bytes, s>>>(
      static_cast<const u64*>(cand), m, k, static_cast<float*>(vo),
      static_cast<int32_t*>(io), offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the tile width the wrapper plans with (kernels/topk/topk.py TILE)
extern "C" int repro_topk_tile() { return TILE; }

#define REPRO_TOPK_LAUNCHER(NAME, T)                                       \
  extern "C" int NAME(const void* x, long long rows, long long n, int k,   \
                      int offset, long long tiles, void* cand, void* vo,   \
                      void* io, void* stream) {                            \
    return launch_topk<T>(x, rows, n, k, offset, tiles, cand, vo, io,      \
                          stream);                                         \
  }

REPRO_TOPK_LAUNCHER(repro_topk_f32, float)
REPRO_TOPK_LAUNCHER(repro_topk_bf16, __nv_bfloat16)
REPRO_TOPK_LAUNCHER(repro_topk_f16, __half)
