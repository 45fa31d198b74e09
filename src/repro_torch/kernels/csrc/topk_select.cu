// Local top-k for k > 256 (the select route) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/topk/topk.py::topk_pallas (body
// _topk_kernel, extraction _extract_topk) where k exceeds MAX_K, the
// largest k the tile route of topk.cu keeps in shared memory.  It
// computes what topk.cu computes and the reference's topk_ref defines:
// the k largest scores of each row compared as f32 (f32, bf16, f16 read
// natively and widened exactly, NaNs included) in the IEEE total order
// of the bits (+NaN > +inf > ... > +0.0 > -0.0 > ... > -inf > -NaN),
// descending, ties to the lowest index, with int32 global indices
// (local index + index_offset); a -inf keeps its real index.
//
// Bound: device-memory bytes, rows * n * elt + rows * k * 8 over
// 3.35 TB/s.  This route reads each score five times (three digits, the
// count, the ties' tiles) and sorts the k winners in scratch; it is the
// first, simple design (no served path runs it yet).  No array of k
// words sits in shared memory, so any k <= n fits:
//
//   select: the k-th largest 32-bit total-order key of each row by a
//     radix select over the row in device memory, one digit a pass (12,
//     10, 10 bits): each pass counts the keys that match the digits found
//     so far into a block histogram (warp-aggregated, so ties do not
//     serialise) and adds it to the row's histogram in scratch; one block
//     a row then finds the bin that holds the need-th largest key and
//     zeroes the histogram.  SEL_TILE scores a block, SEL_UNROLL loads in
//     flight a thread.
//   winners: every key above the threshold goes out as its 64-bit word
//     (key << 32 | (0xffffffff - local)), at a slot from a warp-
//     aggregated counter of the row; each tile also counts its keys equal
//     to the threshold.  Then each tile whose quota of ties is not zero
//     (the need lowest-indexed equal keys of the row, after the earlier
//     tiles' counts) writes its first `quota` equal keys in index order,
//     by a block prefix count, after the winners above.
//   order: one block a row sorts its k words descending by an LSD radix
//     sort, 8 bits a pass, ping-pong between two k-word buffers in
//     scratch; a stable scatter ranks each chunk's words by warp match
//     and a per-warp count in shared memory.  A pass whose digit is one
//     value for all k words is skipped.  The words are distinct, so the
//     order is the words' order: larger score first, then lower index.
//   output: f32 values and int32 indices, as topk.cu writes them.
//
// The wrapper (kernels/topk/topk.py::plan) computes the tiles and the
// scratch (words a row: 2k, the histogram, the row's state, the tiles'
// counts); the launcher refuses other tiles and any k the tile route
// takes; repro_topk_select_plan exports the plan.
//
// Launch counter: repro_torch.kernels._build.LAUNCHES["topk_select"].
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int SEL_THREADS = 512;         // threads of a row-pass block
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SEL_TILE = 16384;          // scores a row-pass block takes
constexpr int SEL_UNROLL = 8;            // loads in flight a thread
constexpr int SEL_FIRST_BITS = 12;       // the digits: 12, 10, 10 bits
constexpr int SEL_BITS = 10;
constexpr int SEL_FIRST_BINS = 1 << SEL_FIRST_BITS;
constexpr int SEL_STATE = 4;             // u32 a row: prefix, need, taken
constexpr int SORT_THREADS = 1024;       // threads of a sorting block
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int SORT_BITS = 8;             // a sort digit
constexpr int SORT_BINS = 1 << SORT_BITS;
constexpr int MAX_K = 256;               // topk.cu's route takes k <= MAX_K
constexpr unsigned FULL = 0xffffffffu;
static_assert(SEL_FIRST_BINS == 8 * SEL_THREADS, "a thread scans 8 bins");
static_assert(SEL_FIRST_BITS + 2 * SEL_BITS == 32, "three digits a key");

// Exact widening by bits, NaNs keeping sign and payload (topk.cu's)
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

// the inverse of key_of
__device__ __forceinline__ float value_of(unsigned key) {
  int b = static_cast<int>(key ^ 0x80000000u);
  b ^= (b >> 31) & 0x7fffffff;
  return __int_as_float(b);
}

__device__ __forceinline__ u64 word_of(unsigned key, long long local) {
  return (static_cast<u64>(key) << 32) |
         static_cast<u64>(0xffffffffu - static_cast<unsigned>(local));
}

// Exclusive prefix sum of x over the block's threads in order, and the
// block's total.  Every thread calls this; it holds two barriers.
template <int WARPS>
__device__ unsigned block_scan(unsigned* warp_sum, unsigned x,
                               unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  unsigned before = inc - x, tot = 0;
  for (int w = 0; w < WARPS; ++w) {
    const unsigned s = warp_sum[w];
    if (w < warp) before += s;
    tot += s;
  }
  __syncthreads();                       // warp_sum is free again
  *total = tot;
  return before;
}

// The scores of one row pass: block b takes tile b % tiles of row
// b / tiles, count scores from lo.
struct Tile {
  long long row, lo;
  int tile, count;
};

__device__ __forceinline__ Tile tile_of(long long n, int tiles) {
  Tile t;
  t.row = blockIdx.x / tiles;
  t.tile = static_cast<int>(blockIdx.x - t.row * tiles);
  t.lo = static_cast<long long>(t.tile) * SEL_TILE;
  t.count = static_cast<int>(n - t.lo < SEL_TILE ? n - t.lo : SEL_TILE);
  return t;
}

// Calls f(i, ok, key) for the tile's scores, SEL_UNROLL loads in flight
// a thread; every lane of every warp calls f for each step (ok false
// past the tile), so f may use warp collectives.
template <typename T, typename F>
__device__ __forceinline__ void for_keys(const T* __restrict__ g, int count,
                                         F f) {
  for (int i0 = 0; i0 < count; i0 += SEL_THREADS * SEL_UNROLL) {
    unsigned key[SEL_UNROLL];
#pragma unroll
    for (int u = 0; u < SEL_UNROLL; ++u) {
      const int i = i0 + u * SEL_THREADS + threadIdx.x;
      key[u] = i < count ? key_of(f32_bits(g[i])) : 0u;
    }
#pragma unroll
    for (int u = 0; u < SEL_UNROLL; ++u) {
      const int i = i0 + u * SEL_THREADS + threadIdx.x;
      f(i, i < count, key[u]);
    }
  }
}

// The row's histogram and state set up: bins zeroed, prefix 0, need k,
// no winner placed.
__global__ void __launch_bounds__(SEL_THREADS)
sel_init(unsigned* __restrict__ hist, unsigned* __restrict__ state, int k) {
  const long long row = blockIdx.x;
  for (int b = threadIdx.x; b < SEL_FIRST_BINS; b += SEL_THREADS)
    hist[row * SEL_FIRST_BINS + b] = 0u;
  if (threadIdx.x == 0) {
    unsigned* s = state + row * SEL_STATE;
    s[0] = 0u;
    s[1] = static_cast<unsigned>(k);
    s[2] = 0u;
    s[3] = 0u;
  }
}

// One digit: count the digit at `shift` (`bits` wide) of every key whose
// digits above it equal the prefix found so far into the row's
// histogram.
template <typename T>
__global__ void __launch_bounds__(SEL_THREADS)
sel_hist(const T* __restrict__ x, long long n, int tiles, int shift,
         int bits, unsigned* __restrict__ hist,
         const unsigned* __restrict__ state) {
  __shared__ unsigned h[SEL_FIRST_BINS];
  const Tile tl = tile_of(n, tiles);
  const int nb = 1 << bits, top = shift + bits;
  for (int b = threadIdx.x; b < nb; b += SEL_THREADS) h[b] = 0u;
  __syncthreads();
  const unsigned prefix = state[tl.row * SEL_STATE];
  const int lane = threadIdx.x & 31;
  for_keys(x + tl.row * n + tl.lo, tl.count,
           [&](int, bool ok, unsigned key) {
             const bool in =
                 ok && (top >= 32 || (key >> top) == (prefix >> top));
             // a bin of nb or above marks no key
             const unsigned bin =
                 in ? (key >> shift) & (nb - 1) : static_cast<unsigned>(nb);
             const unsigned peers = __match_any_sync(FULL, bin);
             if (in && lane == __ffs(peers) - 1)
               atomicAdd(&h[bin], static_cast<unsigned>(__popc(peers)));
           });
  __syncthreads();
  unsigned* row_hist = hist + tl.row * SEL_FIRST_BINS;
  for (int b = threadIdx.x; b < nb; b += SEL_THREADS)
    if (h[b]) atomicAdd(&row_hist[b], h[b]);
}

// One block a row: the bin of the digit at `shift` that holds the
// need-th largest key; the prefix gains it and need drops by the keys
// in higher bins.  The histogram is zeroed for the next digit.
__global__ void __launch_bounds__(SEL_THREADS)
sel_pick(unsigned* __restrict__ hist, unsigned* __restrict__ state,
         int shift, int bits) {
  __shared__ unsigned warp_sum[SEL_WARPS];
  const long long row = blockIdx.x;
  const int t = threadIdx.x, nb = 1 << bits;
  unsigned* s = state + row * SEL_STATE;
  const unsigned need = s[1], prefix = s[0];
  // thread t holds the 8 bins below nb - 8t, top bins first
  unsigned* row_hist = hist + row * SEL_FIRST_BINS;
  const bool mine = t < nb / 8;
  unsigned v[8] = {};
  if (mine) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned* p = row_hist + nb - 1 - 8 * t - j;
      v[j] = *p;
      *p = 0u;
    }
  }
  unsigned tot = 0, total;
#pragma unroll
  for (int j = 0; j < 8; ++j) tot += v[j];
  unsigned above = block_scan<SEL_WARPS>(warp_sum, tot, &total);
  if (mine) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (above < need && above + v[j] >= need) {
        s[0] = prefix | (static_cast<unsigned>(nb - 1 - 8 * t - j) << shift);
        s[1] = need - above;
      }
      above += v[j];
    }
  }
}

// The threshold is the prefix, and need the keys equal to it still
// wanted.  Every key above it goes out as a word at the next of the
// row's first k - need slots; each tile counts its keys equal to it.
template <typename T>
__global__ void __launch_bounds__(SEL_THREADS)
sel_count(const T* __restrict__ x, long long n, int k, int tiles,
          unsigned* __restrict__ state, unsigned* __restrict__ counts,
          u64* __restrict__ words) {
  __shared__ unsigned warp_sum[SEL_WARPS];
  const Tile tl = tile_of(n, tiles);
  unsigned* s = state + tl.row * SEL_STATE;
  const unsigned thr = s[0];
  u64* out = words + tl.row * k;
  const int lane = threadIdx.x & 31;
  unsigned eq = 0;
  for_keys(x + tl.row * n + tl.lo, tl.count,
           [&](int i, bool ok, unsigned key) {
             const bool gt = ok && key > thr;
             eq += ok && key == thr;
             const unsigned m = __ballot_sync(FULL, gt);
             if (m == 0u) return;
             const int first = __ffs(m) - 1;
             unsigned base = 0;
             if (lane == first) base = atomicAdd(&s[2], __popc(m));
             base = __shfl_sync(FULL, base, first);
             if (gt)
               out[base + __popc(m & ((1u << lane) - 1u))] =
                   word_of(key, tl.lo + i);
           });
  unsigned all;
  block_scan<SEL_WARPS>(warp_sum, eq, &all);
  if (threadIdx.x == 0) counts[tl.row * tiles + tl.tile] = all;
}

// The ties: a tile writes its first `quota` keys equal to the threshold,
// in index order, where quota is what the row's need leaves after the
// earlier tiles' equal keys; the slots follow the k - need words above.
template <typename T>
__global__ void __launch_bounds__(SEL_THREADS)
sel_ties(const T* __restrict__ x, long long n, int k, int tiles,
         const unsigned* __restrict__ state,
         const unsigned* __restrict__ counts, u64* __restrict__ words) {
  __shared__ unsigned warp_sum[SEL_WARPS];
  const Tile tl = tile_of(n, tiles);
  const unsigned* s = state + tl.row * SEL_STATE;
  const unsigned thr = s[0], need = s[1];
  const unsigned* row_counts = counts + tl.row * tiles;
  unsigned part = 0, before;
  for (int j = threadIdx.x; j < tl.tile; j += SEL_THREADS)
    part += row_counts[j];
  block_scan<SEL_WARPS>(warp_sum, part, &before);
  const unsigned here = row_counts[tl.tile];
  const unsigned left = need > before ? need - before : 0u;
  const unsigned quota = left < here ? left : here;
  if (quota == 0u) return;              // the same for every thread
  u64* out = words + tl.row * k + (k - need) + before;
  const T* g = x + tl.row * n + tl.lo;
  unsigned taken = 0;
  for (int i0 = 0; i0 < tl.count && taken < quota; i0 += SEL_THREADS) {
    const int i = i0 + threadIdx.x;
    const bool eq = i < tl.count && key_of(f32_bits(g[i])) == thr;
    unsigned chunk;
    const unsigned rank = block_scan<SEL_WARPS>(warp_sum, eq, &chunk);
    if (eq && taken + rank < quota) out[taken + rank] = word_of(thr, tl.lo + i);
    taken += chunk;
  }
}

// sort digit of a word at `shift`, ascending for descending words
__device__ __forceinline__ unsigned sort_digit(u64 w, int shift) {
  return (SORT_BINS - 1) - static_cast<unsigned>((w >> shift) & (SORT_BINS - 1));
}

// One block a row: its k words sorted descending by an LSD radix sort
// between w0 and w1, then the values and indices written.
__global__ void __launch_bounds__(SORT_THREADS)
sel_sort(u64* w0, u64* w1, int k, float* __restrict__ vo,
         int32_t* __restrict__ io, int offset) {
  __shared__ unsigned base[SORT_BINS];   // digit counts, then slots
  __shared__ unsigned wcnt[SORT_WARPS][SORT_BINS];
  const long long row = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  u64* src = w0 + row * k;
  u64* dst = w1 + row * k;
  for (int shift = 0; shift < 64; shift += SORT_BITS) {
    if (t < SORT_BINS) base[t] = 0u;
    __syncthreads();
    for (int i = t; i < k; i += SORT_THREADS)
      atomicAdd(&base[sort_digit(src[i], shift)], 1u);
    __syncthreads();
    // one digit for all k words: the order stays
    if (__syncthreads_or(t < SORT_BINS &&
                         base[t] == static_cast<unsigned>(k)))
      continue;
    if (t == 0) {
      unsigned run = 0;
      for (int b = 0; b < SORT_BINS; ++b) {
        const unsigned c = base[b];
        base[b] = run;
        run += c;
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < k; c0 += SORT_THREADS) {
      for (int i = t; i < SORT_WARPS * SORT_BINS; i += SORT_THREADS)
        (&wcnt[0][0])[i] = 0u;
      __syncthreads();
      const int i = c0 + t;
      const bool ok = i < k;
      const u64 w = ok ? src[i] : 0ull;
      const unsigned d = ok ? sort_digit(w, shift) : SORT_BINS;
      const unsigned peers = __match_any_sync(FULL, d);
      const unsigned rank = __popc(peers & ((1u << lane) - 1u));
      if (ok && rank == 0u) wcnt[warp][d] = __popc(peers);
      __syncthreads();
      if (t < SORT_BINS) {               // each digit's slots by warp
        unsigned run = base[t];
        for (int v = 0; v < SORT_WARPS; ++v) {
          const unsigned c = wcnt[v][t];
          wcnt[v][t] = run;
          run += c;
        }
        base[t] = run;
      }
      __syncthreads();
      if (ok) dst[wcnt[warp][d] + rank] = w;
      __syncthreads();
    }
    u64* tmp = src;
    src = dst;
    dst = tmp;
  }
  for (int q = t; q < k; q += SORT_THREADS) {
    const u64 w = src[q];
    vo[row * k + q] = value_of(static_cast<unsigned>(w >> 32));
    io[row * k + q] =
        static_cast<int32_t>(0xffffffffu - static_cast<unsigned>(w)) + offset;
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The plan of a row of n scores at k (kernels/topk/topk.py::plan, the
// select route): tiles of SEL_TILE scores, and int64 scratch words a
// row: two k-word buffers, the histogram (SEL_FIRST_BINS u32), the
// row's state (SEL_STATE u32) and the tiles' counts (u32 each).
bool make_plan(long long n, long long k, long long* tiles, long long* words) {
  if (k <= MAX_K || k > n || n > 0x7fffffffLL) return false;
  *tiles = cdiv(n, SEL_TILE);
  *words = 2 * k + SEL_FIRST_BINS / 2 + SEL_STATE / 2 + cdiv(*tiles, 2);
  return true;
}

template <typename T>
int launch_select(const void* x, long long rows, long long n, int k,
                  int offset, long long tiles, void* scratch, void* vo,
                  void* io, void* stream) {
  if (rows <= 0) return 0;
  // the wrapper's plan must be this launcher's
  long long want_tiles, words;
  if (!make_plan(n, k, &want_tiles, &words) || tiles != want_tiles ||
      scratch == nullptr || rows * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // the scratch by sections, each rows times its words a row
  u64* w0 = static_cast<u64*>(scratch);
  u64* w1 = w0 + rows * k;
  unsigned* hist = reinterpret_cast<unsigned*>(w1 + rows * k);
  unsigned* state = hist + rows * SEL_FIRST_BINS;
  unsigned* counts = state + rows * SEL_STATE;
  const T* xs = static_cast<const T*>(x);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid_rows = static_cast<unsigned>(rows);
  const unsigned grid_tiles = static_cast<unsigned>(rows * tiles);
  const int t = static_cast<int>(tiles);
  sel_init<<<grid_rows, SEL_THREADS, 0, st>>>(hist, state, k);
  cudaError_t err = cudaGetLastError();
  const int shifts[3] = {32 - SEL_FIRST_BITS, SEL_BITS, 0};
  const int widths[3] = {SEL_FIRST_BITS, SEL_BITS, SEL_BITS};
  for (int p = 0; p < 3 && err == cudaSuccess; ++p) {
    sel_hist<T><<<grid_tiles, SEL_THREADS, 0, st>>>(xs, n, t, shifts[p],
                                                    widths[p], hist, state);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    sel_pick<<<grid_rows, SEL_THREADS, 0, st>>>(hist, state, shifts[p],
                                                widths[p]);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  sel_count<T><<<grid_tiles, SEL_THREADS, 0, st>>>(xs, n, k, t, state,
                                                   counts, w0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sel_ties<T><<<grid_tiles, SEL_THREADS, 0, st>>>(xs, n, k, t, state, counts,
                                                  w0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sel_sort<<<grid_rows, SORT_THREADS, 0, st>>>(
      w0, w1, k, static_cast<float*>(vo), static_cast<int32_t*>(io), offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The select route's plan of a row of n scores at k: out[0] tiles,
// out[1] int64 scratch words a row; cudaErrorInvalidValue where the
// route does not take the request (k <= MAX_K, k > n).
extern "C" int repro_topk_select_plan(long long n, int k, long long* out) {
  if (!make_plan(n, k, &out[0], &out[1]))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

#define REPRO_TOPK_SELECT_LAUNCHER(NAME, T)                                \
  extern "C" int NAME(const void* x, long long rows, long long n, int k,   \
                      int offset, long long tiles, void* scratch,          \
                      void* vo, void* io, void* stream) {                  \
    return launch_select<T>(x, rows, n, k, offset, tiles, scratch, vo, io, \
                            stream);                                       \
  }

REPRO_TOPK_SELECT_LAUNCHER(repro_topk_select_f32, float)
REPRO_TOPK_SELECT_LAUNCHER(repro_topk_select_bf16, __nv_bfloat16)
REPRO_TOPK_SELECT_LAUNCHER(repro_topk_select_f16, __half)
