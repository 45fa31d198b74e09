// Local top-k for k > 256 (the select routes) for Hopper (sm_90a).
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
// 3.35 TB/s.  A score is a 32-bit total-order key; the result orders a
// row's scores by key, then by lower index.  Two routes, chosen by plan
// (resident_bytes against RESIDENT_SMEM):
//
//   resident (the row, its winners and the room fit one block's shared
//     memory): ONE launch, one block of 512 threads a row, and each
//     score is read from device memory ONCE: the block streams the row
//     in 16-byte loads into shared memory as keys, counting the first
//     12-bit digit as they arrive (a lane adds its 4 keys once when they
//     share a bin, a warp 128 once, so a row of one repeated value does
//     not serialise), and picks the bin of the k-th key by a block scan.
//     Every later pass runs over the keys in shared memory, a 16-byte
//     vector a thread:
//     - narrow: the bin's keys are gathered in the histogram's room
//       (at most CAND_K; else the row stands in for them) and 8-bit
//       digits narrow the bin to the k-th key T; a pass whose bin keys
//       are one value ends there (its least and largest key agree);
//     - compact: the winners are every key above T and the first
//       need_eq keys equal to T in row order.  Each (round, warp) cell
//       of vectors counts its winners, a block scan of the cells gives
//       each its first slot, a warp scan each lane's, so the winners
//       land in row order with no match and no atomic: in one pass when
//       no tie is cut (each warp stages its winners in the room, STAGE
//       at most), else in two (count, then write);
//     - sort: up to SORT_SLOTS winners a bitonic network in registers
//       (shuffles within a warp, shared memory across warps); more, a
//       stable LSD radix sort of the 32-bit keys (row order breaks the
//       ties), 8 bits a pass, the row's bytes as its second buffer, a
//       pass of one digit skipped, digits counted by shared-memory adds
//       and lanes ranked by eight ballots.
//   long (any other row): THREE launches, and each score is read TWICE:
//     count: a cluster of CLUSTER blocks a row counts the 14-bit first
//       digit of its share in shared memory; the blocks sum the
//       histograms through distributed shared memory, a slice each, and
//       the block whose slice holds the k-th key picks its bin and
//       writes the row's state (no buffer needs zeroing, no atomic in
//       device memory);
//     tiles: one block per LTILE scores reads them again, runs the
//       resident narrow and compact over them, and writes its keys above
//       the bin and its largest min(bin keys, need) bin keys, in row
//       order, to its own region of scratch, and its line (those two
//       counts, the bin's least and largest key);
//     final: one block a row gathers the regions in order and runs the
//       resident narrow, compact and sort over them: in shared memory
//       when they and the k winners fit, else in scratch (heavy ties, a
//       k beyond shared memory).  When the row's bin holds one key value
//       the winners are the first `need` bin keys in row order, so the
//       gather takes the keys above the bin and those alone.
//   output: f32 values and int32 indices, as topk.cu writes them.
//
// The wrapper (kernels/topk/topk.py::plan) computes the route, the
// tiles and the scratch; repro_topk_select_plan exports the same plan;
// the launcher refuses any other plan and any k the tile route takes.
//
// Launch counter: repro_torch.kernels._build.LAUNCHES["topk_select"].
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {


constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int RES_BITS = 12;             // the resident route's first digit
constexpr int RES_BINS = 1 << RES_BITS;
constexpr int LONG_BITS = 14;            // the long route's first digit
constexpr int LONG_BINS = 1 << LONG_BITS;
constexpr int CLUSTER = 8;               // blocks a row in the long count
constexpr int SLICE = LONG_BINS / CLUSTER;
constexpr int LTILE = 16384;             // scores a long-route tile block
constexpr int BITS = 8;                  // a later digit, and a sort digit
constexpr int BINS = 1 << BITS;
constexpr int ROOM = 4096;               // u32 of the histogram's room
constexpr int CAND_K = 3840;             // bin keys gathered in the room
constexpr int CHUNK = 32;                // rounds a compaction scan takes
constexpr int STAGE = 112;               // winners a warp stages in the room
constexpr int SORT_SLOTS = 512;          // the bitonic sort's most pairs
constexpr int UNROLL = 4;                // 16-byte loads in flight a thread
constexpr int WALK = 2;                  // vectors or chunks in flight
constexpr int MAX_K = 256;               // topk.cu's route takes k <= MAX_K
constexpr int ROOM_AT = 512;             // bytes: Shared, then the room
constexpr int FIXED_BYTES = 16896;       // ROOM_AT + the room; keys follow
constexpr int RESIDENT_SMEM = 232448;    // a block's shared memory (sm_90)
constexpr int STATE = 4;                 // u32 a row: bin, need, count, above
constexpr int LINE = 4;                  // u32 a tile: above, kept, least, largest
constexpr int COUNT_BYTES = 4 * LONG_BINS + 4 * CLUSTER + 4 * WARPS;
constexpr int TILE_BYTES = FIXED_BYTES + 4 * (LTILE + 4);
constexpr unsigned FULL = 0xffffffffu;
static_assert(RES_BINS == ROOM && WARPS * BINS == ROOM, "the room");
static_assert(CAND_K + BINS <= ROOM && CHUNK * WARPS == THREADS &&
              2 * THREADS <= ROOM && THREADS + 2 * STAGE * WARPS <= ROOM,
              "the room's uses");
static_assert(FIXED_BYTES == ROOM_AT + 4 * ROOM, "layout");
static_assert(SLICE == 4 * THREADS && RES_BINS == 8 * THREADS, "bins");
static_assert(2 * BINS == THREADS, "a sort scan: two threads a digit");
static_assert(SORT_SLOTS == THREADS, "a bitonic slot a thread");
// two tile blocks share an SM (228 KB, 1 KB reserved a block)
static_assert(2 * (TILE_BYTES + 1024) <= 228 * 1024, "2 tiles an SM");

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

// The block's shared state; the histogram's room and the keys follow.
struct alignas(16) Shared {
  unsigned lo, hi;             // the bin of the k-th key, [lo, hi]
  int need;                    // keys still wanted from that bin
  int cnt;                     // keys in that bin
  unsigned mn, mx;             // the least and largest key in the bin
  unsigned warp_sum[WARPS];
  unsigned above[2];           // a chunk's keys above and equal to T
};
static_assert(sizeof(Shared) <= ROOM_AT, "Shared fits before the room");

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

// Count the bins of a lane's 4 keys (ok: counted); every lane of the
// warp calls this.  A lane whose 4 keys share a bin adds 4 once, and a
// warp whose lanes all do so on one bin adds 128 once, so a row of one
// repeated value does not serialise on a counter.
__device__ __forceinline__ void hist_add4(unsigned* h, const unsigned* bin,
                                          const bool* ok) {
  const bool same = ok[0] && ok[1] && ok[2] && ok[3] && bin[1] == bin[0] &&
                    bin[2] == bin[0] && bin[3] == bin[0];
  const unsigned b0 = __shfl_sync(FULL, bin[0], 0);
  if (__all_sync(FULL, same && bin[0] == b0)) {
    if ((threadIdx.x & 31) == 0) atomicAdd(&h[b0], 128u);
  } else if (same) {
    atomicAdd(&h[bin[0]], 4u);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ok[e]) atomicAdd(&h[bin[e]], 1u);
  }
}

// Exclusive prefix sum of x over the block's threads in order.  Every
// thread calls this; warp_sum is free again after the next barrier.
__device__ unsigned block_exclusive(unsigned* warp_sum, unsigned x) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  unsigned before = inc - x;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  return before;
}

// The sum of x over the block; two barriers, warp_sum free after them.
__device__ unsigned block_sum(unsigned* warp_sum, unsigned x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = x;
  __syncthreads();
  unsigned tot = 0;
  for (int w = 0; w < WARPS; ++w) tot += warp_sum[w];
  __syncthreads();
  return tot;
}

// Narrow [lo, hi] to the bin of the NB-bin digit at `shift` that holds
// the need-th largest key, zeroing the histogram h.  Every thread of the
// block calls this; it starts and ends with a barrier.
template <int NB>
__device__ void pick_bin(Shared& s, unsigned* h, int shift) {
  const int t = threadIdx.x;
  __syncthreads();                       // the histogram is complete
  const unsigned need = static_cast<unsigned>(s.need);
  // thread t holds the 8 bins below NB - 8t, read and zeroed as two
  // 16-byte words: the top bins first
  const bool mine = t < NB / 8;
  unsigned v[8] = {};
  if (mine) {
    uint4* p = reinterpret_cast<uint4*>(h + NB - 8 * (t + 1));
    const uint4 a = p[0], b = p[1];
    p[0] = p[1] = make_uint4(0u, 0u, 0u, 0u);
    v[0] = b.w; v[1] = b.z; v[2] = b.y; v[3] = b.x;
    v[4] = a.w; v[5] = a.z; v[6] = a.y; v[7] = a.x;
  }
  unsigned tot = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) tot += v[j];
  unsigned above = block_exclusive(s.warp_sum, tot);  // keys in higher bins
  if (mine) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (above < need && above + v[j] >= need) {
        const unsigned lo =
            s.lo | (static_cast<unsigned>(NB - 1 - 8 * t - j) << shift);
        s.lo = lo;
        s.hi = lo | ((1u << shift) - 1u);
        s.need = static_cast<int>(need - above);
        s.cnt = static_cast<int>(v[j]);
      }
      above += v[j];
    }
  }
  __syncthreads();
}

// A list of m keys at keys[sh, sh + m) of a 16-byte-aligned array (in
// shared or device memory): position p is keys[sh + p], of row index
// idx[p] (idx == nullptr: base + p).  The positions rise with the row
// index, so a list's order is its row's.  Thread t takes the 16-byte
// vectors t, t + THREADS, ... of the array, a round of THREADS vectors
// at a time; slots outside the list are masked.
struct List {
  const unsigned* keys;
  int sh, m;
  const unsigned* idx;
  unsigned base;
};

__device__ __forceinline__ int vectors_of(const List& L) {
  return (L.sh + L.m + 3) >> 2;
}

// Calls f(q, in, kk) for this thread's vectors q in [q_lo, q_hi) (q_lo
// a multiple of THREADS), in[e] where slot e of the vector is a position
// of the list; WALK rounds of loads in flight.  Every thread of the
// block runs the same steps, so f may use warp collectives.
template <typename F>
__device__ __forceinline__ void for_vectors(const List& L, int q_lo, int q_hi,
                                            F f) {
  const uint4* v = reinterpret_cast<const uint4*>(L.keys);
  for (int q0 = q_lo; q0 < q_hi; q0 += THREADS * WALK) {
    uint4 buf[WALK];
#pragma unroll
    for (int u = 0; u < WALK; ++u) {
      const int q = q0 + u * THREADS + threadIdx.x;
      buf[u] = q < q_hi ? v[q] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < WALK; ++u) {
      const int q = q0 + u * THREADS + threadIdx.x;
      const unsigned kk[4] = {buf[u].x, buf[u].y, buf[u].z, buf[u].w};
      bool in[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 4 * q + e - L.sh;
        in[e] = q < q_hi && p >= 0 && p < L.m;
      }
      f(q, in, kk);
    }
  }
}

// Fold each thread's least and largest bin key into s.mn, s.mx (set to
// 0xffffffff and 0 before, behind a barrier); every thread calls this.
// They are read after the next barrier.
__device__ __forceinline__ void bin_extremes(Shared& s, unsigned mn,
                                             unsigned mx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(FULL, mn, off));
    mx = max(mx, __shfl_xor_sync(FULL, mx, off));
  }
  if ((threadIdx.x & 31) == 0 && mn <= mx) {
    atomicMin(&s.mn, mn);
    atomicMax(&s.mx, mx);
  }
}

// Refine [lo, hi] over the list one byte at a time from `shift` down
// (the last digit clamped to bit 0) until the bin holds exactly the keys
// still wanted or one key; h is a zeroed BINS-bin histogram.  A pass
// also finds the least and largest key in the bin, so a bin of one key
// value ends the refinement at once.
__device__ void refine(Shared& s, unsigned* h, const List& L, int shift) {
  while (s.cnt != s.need && s.lo != s.hi) {
    const unsigned lo = s.lo, hi = s.hi;
    __syncthreads();                     // every thread has read lo, hi
    if (threadIdx.x == 0) {
      s.mn = 0xffffffffu;
      s.mx = 0u;
    }
    __syncthreads();
    unsigned mn = 0xffffffffu, mx = 0u;
    for_vectors(L, 0, vectors_of(L),
                [&](int, const bool* in, const unsigned* kk) {
      bool b[4];
      unsigned d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        b[e] = in[e] && kk[e] >= lo && kk[e] <= hi;
        d[e] = (kk[e] >> shift) & (BINS - 1);
        if (b[e]) {
          mn = min(mn, kk[e]);
          mx = max(mx, kk[e]);
        }
      }
      hist_add4(h, d, b);
    });
    bin_extremes(s, mn, mx);
    pick_bin<BINS>(s, h, shift);
    if (s.mn == s.mx) {                  // one key value: it is the bin
      if (threadIdx.x == 0) s.lo = s.hi = s.mn;
      __syncthreads();
      break;
    }
    if (shift == 0) break;
    shift = shift > BITS ? shift - BITS : 0;
  }
}

// The keys of a list above thr written in list order to (ok, oi) as
// (key, row index) in one pass: each warp stages its winners, in its
// cells' order, in its own slice of the room (STAGE pairs), lane 0 of
// the warp counts each (round, warp) cell; a block scan of the cells
// gives each its first slot, and each warp copies its slice out.
// Returns how many, or -1 when a warp's winners overflow its slice (the
// room is then to be zeroed again by the caller's next use).  Every
// thread calls this; it starts and ends with a barrier.
__device__ int compact_above(Shared& s, unsigned* room, const List& L,
                             long long thr, unsigned* ok, unsigned* oi) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nq = vectors_of(L);
  if (nq > CHUNK * THREADS) return -1;   // more cells than one scan
  unsigned* cells = room;
  unsigned* sk = room + THREADS + warp * 2 * STAGE;
  unsigned* si = sk + STAGE;
  __syncthreads();
  cells[t] = 0u;
  __syncthreads();
  unsigned staged = 0;                   // this warp's winners so far
  for_vectors(L, 0, nq, [&](int q, const bool* in, const unsigned* kk) {
    unsigned x = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) x += in[e] && kk[e] > thr;
    unsigned inc = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc += y;
    }
    const unsigned total = __shfl_sync(FULL, inc, 31);
    if (lane == 0 && q < nq) cells[(q / THREADS) * WARPS + warp] = total;
    unsigned at = staged + inc - x;
    if (staged + total <= STAGE) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (in[e] && kk[e] > thr) {
          const int p = 4 * q + e - L.sh;
          sk[at] = kk[e];
          si[at] = L.idx ? L.idx[p] : L.base + static_cast<unsigned>(p);
          ++at;
        }
      }
    }
    staged += total;
  });
  if (__syncthreads_or(staged > STAGE)) return -1;
  const unsigned c = cells[t];
  const unsigned before = block_exclusive(s.warp_sum, c);
  __syncthreads();
  cells[t] = before;
  if (t == THREADS - 1) s.above[0] = before + c;
  __syncthreads();
  // each warp's slice holds its cells in round order
  unsigned from = 0;
  for (int j = 0; j * THREADS < nq; ++j) {
    const int cell = j * WARPS + warp;
    const unsigned to = cells[cell];
    const unsigned next = cell + 1 < THREADS ? cells[cell + 1]
                                             : s.above[0];
    const unsigned cnt = next - to;
    for (unsigned e = lane; e < cnt; e += 32) {
      ok[to + e] = sk[from + e];
      oi[to + e] = si[from + e];
    }
    from += cnt;
  }
  __syncthreads();
  return static_cast<int>(s.above[0]);
}

// The winners of a list: every key above the bin [s.lo, s.hi] (keys)
// and the s.need largest of its s.cnt keys, the lowest positions first
// among equal keys.  Narrows the bin to the k-th key T (over the bin's
// keys gathered in the room when at most CAND_K, else over the list),
// then writes the winners, in list order, to (ok, oi) as (key, row
// index): each key above T, and the first need_eq keys equal to T.
// Each (round, warp) cell counts its keys above and equal to T; a block
// scan of THREADS cells at a time gives each its first slot, and a warp
// scan each lane's.  The room holds a zeroed BINS-bin histogram.
// none_above: the caller knows that no key of the list lies above the
// bin and that the bin is one key value.  Returns how many.  Every thread calls this; it starts and ends
// with a barrier.
__device__ int select_compact(Shared& s, unsigned* room, const List& L,
                              int first_bits, unsigned* ok, unsigned* oi,
                              int none_above = 0) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nq = vectors_of(L);
  const int shift = 32 - first_bits - BITS;
  __syncthreads();
  if (s.cnt != s.need && s.lo != s.hi) {
    if (s.cnt <= CAND_K) {
      // gather the bin's keys after the histogram, in any order
      const unsigned lo = s.lo, hi = s.hi;
      unsigned mine = 0;
      for_vectors(L, 0, nq, [&](int, const bool* in, const unsigned* kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine += in[e] && kk[e] >= lo && kk[e] <= hi;
      });
      unsigned at = block_exclusive(s.warp_sum, mine);
      unsigned* g = room + BINS;
      for_vectors(L, 0, nq, [&](int, const bool* in, const unsigned* kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (in[e] && kk[e] >= lo && kk[e] <= hi) g[at++] = kk[e];
      });
      __syncthreads();
      refine(s, room, List{g, 0, s.cnt, nullptr, 0u}, shift);
    } else {
      refine(s, room, L, shift);
    }
  }
  __syncthreads();
  // the k-th key T (signed: lo - 1 takes the whole bin, also at lo = 0),
  // and how many keys equal to T win
  const bool one = s.lo == s.hi;
  const long long T = static_cast<long long>(s.lo) - (one ? 0 : 1);
  const unsigned need_eq = one ? static_cast<unsigned>(s.need) : 0u;
  if (!one || s.need == s.cnt) {
    // no tie is cut: the winners are the keys above T, or from T on
    const int c = compact_above(s, room, L, one ? T - 1 : T, ok, oi);
    if (c >= 0) return c;
  }
  unsigned* cell_gt = room;              // per (round, warp) cell
  unsigned* cell_eq = room + THREADS;
  unsigned gt_run = 0, eq_run = 0;       // keys above, equal to T so far
  // with no key above T the winners are the first need_eq keys equal to
  // T: a round at a time, up to the round that holds the last of them
  const bool early = one && none_above;
  const int span = early ? THREADS : CHUNK * THREADS;
  for (int q_lo = 0; q_lo < nq && !(early && eq_run >= need_eq);
       q_lo += span) {
    const int q_hi = min(q_lo + span, nq);
    __syncthreads();
    cell_gt[t] = 0u;
    cell_eq[t] = 0u;
    __syncthreads();
    // each cell's keys above T and equal to T (one vector a lane)
    for_vectors(L, q_lo, q_hi, [&](int q, const bool* in,
                                   const unsigned* kk) {
      unsigned x = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x += (in[e] && kk[e] > T) + ((in[e] && kk[e] == T) << 16);
      x = __reduce_add_sync(FULL, x);
      const int c = ((q - q_lo) / THREADS) * WARPS + warp;
      if (lane == 0 && q < q_hi) {
        cell_gt[c] = x & 0xffffu;
        cell_eq[c] = x >> 16;
      }
    });
    __syncthreads();
    const unsigned g = cell_gt[t], e = cell_eq[t];
    const unsigned gb = block_exclusive(s.warp_sum, g);
    __syncthreads();
    const unsigned eb = block_exclusive(s.warp_sum, e);
    __syncthreads();
    cell_gt[t] = gt_run + gb;            // keys above T before the cell
    cell_eq[t] = eq_run + eb;            // keys equal to T before it
    if (t == THREADS - 1) {
      s.above[0] = gb + g;
      s.above[1] = eb + e;
    }
    __syncthreads();
    // write the winners: a lane's keys follow the lower lanes' keys
    for_vectors(L, q_lo, q_hi, [&](int q, const bool* in,
                                   const unsigned* kk) {
      bool gt[4], eq[4];
      unsigned x = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gt[j] = in[j] && kk[j] > T;
        eq[j] = in[j] && kk[j] == T;
        x += gt[j] + (eq[j] << 16);
      }
      unsigned inc = x;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, inc, off);
        if (lane >= off) inc += y;
      }
      if (q >= q_hi) return;
      const int c = ((q - q_lo) / THREADS) * WARPS + warp;
      unsigned gbq = cell_gt[c] + ((inc - x) & 0xffffu);
      unsigned ebq = cell_eq[c] + ((inc - x) >> 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gt[j] || (eq[j] && ebq < need_eq)) {
          const unsigned slot = gbq + min(ebq, need_eq);
          const int p = 4 * q + j - L.sh;
          ok[slot] = kk[j];
          oi[slot] = L.idx ? L.idx[p] : L.base + static_cast<unsigned>(p);
        }
        gbq += gt[j];
        ebq += eq[j];
      }
    });
    gt_run += s.above[0];
    eq_run += s.above[1];
  }
  __syncthreads();
  return static_cast<int>(gt_run + min(eq_run, need_eq));
}

// Calls f(i, ok, key) for positions [a, b) of keys, in order, in chunks
// of 32 (lane = i % 32 of the chunk), WALK chunks of loads in flight;
// every lane calls f for each chunk, so f may use warp collectives.
template <typename F>
__device__ __forceinline__ void walk(const unsigned* keys, int a, int b,
                                     F f) {
  const int lane = threadIdx.x & 31;
  for (int i0 = a; i0 < b; i0 += WALK * 32) {
    unsigned kk[WALK];
#pragma unroll
    for (int u = 0; u < WALK; ++u) {
      const int i = i0 + u * 32 + lane;
      kk[u] = i < b ? keys[i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < WALK; ++u) {
      const int i = i0 + u * 32 + lane;
      f(i, i < b, kk[u]);
    }
  }
}

// A warp's segment of m items: 32-aligned, in order.
__device__ __forceinline__ int seg_len(int m) {
  return ((m + WARPS - 1) / WARPS + 31) & ~31;
}

// The lanes of the warp whose digit d equals this lane's, among lanes
// with ok; every lane calls this.  Eight ballots, no match.
__device__ __forceinline__ unsigned peers_of(unsigned d, bool ok) {
  unsigned peers = __ballot_sync(FULL, ok);
#pragma unroll
  for (int bit = 0; bit < BITS; ++bit) {
    const bool set = (d >> bit) & 1u;
    const unsigned bal = __ballot_sync(FULL, set);
    peers &= set ? bal : ~bal;
  }
  return peers;
}

__device__ __forceinline__ unsigned sort_digit(unsigned key, int shift) {
  return (BINS - 1) - ((key >> shift) & (BINS - 1));
}

// A stable LSD radix sort of m (key, index) pairs, descending by key,
// 8 bits a pass, from (ka, ia) through (kb, ib); on return (ka, ia)
// holds the result.  Each warp takes a 32-aligned segment in order and
// counts its digits into its own row of the room; a block scan in
// (digit, warp) order gives every warp its slots.  A pass whose digit is
// one value for all m keys is skipped.  Every thread calls this.
__device__ void sort_desc(Shared& s, unsigned* room, unsigned*& ka,
                          unsigned*& ia, unsigned*& kb, unsigned*& ib,
                          int m) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int seg = seg_len(m);
  const int a = min(warp * seg, m), b = min(a + seg, m);
  const unsigned lt = (1u << lane) - 1u;
  unsigned* wh = room + warp * BINS;
  for (int shift = 0; shift < 32; shift += BITS) {
    __syncthreads();
    for (int i = t; i < WARPS * BINS; i += THREADS) room[i] = 0u;
    __syncthreads();
    const unsigned* src = ka;
    walk(ka, a, b, [&](int, bool ok, unsigned key) {
      if (ok) atomicAdd(&wh[sort_digit(key, shift)], 1u);
    });
    __syncthreads();
    // thread t: digit t / 2 of warps 8 (t % 2) ... 8 (t % 2) + 7
    const int d = t >> 1, w0 = (t & 1) * (WARPS / 2);
    unsigned c[WARPS / 2], sum = 0;
#pragma unroll
    for (int j = 0; j < WARPS / 2; ++j) {
      c[j] = room[(w0 + j) * BINS + d];
      sum += c[j];
    }
    const unsigned tot = sum + __shfl_xor_sync(FULL, sum, 1);
    if (__syncthreads_or(tot == static_cast<unsigned>(m))) continue;
    unsigned before = block_exclusive(s.warp_sum, sum);
#pragma unroll
    for (int j = 0; j < WARPS / 2; ++j) {
      room[(w0 + j) * BINS + d] = before;
      before += c[j];
    }
    __syncthreads();
    walk(src, a, b, [&](int i, bool ok, unsigned key) {
      const unsigned dd = ok ? sort_digit(key, shift) : 0u;
      const unsigned peers = peers_of(dd, ok);
      const unsigned rank = __popc(peers & lt);
      unsigned q = 0;
      if (ok) q = wh[dd] + rank;
      __syncwarp();
      if (ok && rank == 0u) wh[dd] += __popc(peers);
      if (ok) {
        kb[q] = key;
        ib[q] = ia[i];
      }
      __syncwarp();
    });
    unsigned* tk = ka; ka = kb; kb = tk;
    unsigned* ti = ia; ia = ib; ib = ti;
  }
  __syncthreads();
}

// The k sorted pairs as f32 values and int32 global indices.
__device__ void write_out(const unsigned* ka, const unsigned* ia, int k,
                          float* vo, int32_t* io, int offset) {
  for (int q = threadIdx.x; q < k; q += THREADS) {
    vo[q] = value_of(ka[q]);
    io[q] = static_cast<int32_t>(ia[q]) + offset;
  }
}

// Pair a goes before pair b in the result: the larger key, then the
// lower index (the indices of a row are distinct).
__device__ __forceinline__ bool first(unsigned ka, unsigned ia, unsigned kb,
                                      unsigned ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// A bitonic sort of m <= THREADS (key, index) pairs into the result's
// order, one slot a thread (slots past m hold (0, 0xffffffff), which
// goes after every pair): a stage within a warp exchanges by shuffles,
// one across warps through (kb, ib), which hold THREADS pairs.  Writes
// the m sorted pairs as f32 values and int32 global indices.  Every
// thread calls this.
__device__ void bitonic_out(const unsigned* ka, const unsigned* ia, int m,
                            unsigned* kb, unsigned* ib, float* vo,
                            int32_t* io, int offset) {
  const int t = threadIdx.x;
  unsigned k = t < m ? ka[t] : 0u;
  unsigned x = t < m ? ia[t] : 0xffffffffu;
  for (int s = 2; s <= THREADS; s <<= 1) {
    for (int j = s >> 1; j > 0; j >>= 1) {
      unsigned pk, px;
      if (j < 32) {
        pk = __shfl_xor_sync(FULL, k, j);
        px = __shfl_xor_sync(FULL, x, j);
      } else {
        __syncthreads();
        kb[t] = k;
        ib[t] = x;
        __syncthreads();
        pk = kb[t ^ j];
        px = ib[t ^ j];
      }
      // the lower slot of a descending pair keeps the first pair
      const bool mine = first(k, x, pk, px);
      if (((t & j) == 0) == ((t & s) == 0) ? !mine : mine) {
        k = pk;
        x = px;
      }
    }
  }
  if (t < m) {
    vo[t] = value_of(k);
    io[t] = static_cast<int32_t>(x) + offset;
  }
}

// The k winners (ka, ia) in the result's order as f32 values and int32
// global indices: a bitonic sort in registers up to SORT_SLOTS, else
// the radix sort between (ka, ia) and (kb, ib) (room for
// max(k, SORT_SLOTS) pairs).  Every thread calls this.
__device__ void sort_out(Shared& s, unsigned* room, unsigned* ka,
                         unsigned* ia, unsigned* kb, unsigned* ib, int k,
                         float* vo, int32_t* io, int offset) {
  __syncthreads();
  if (k <= SORT_SLOTS) {
    bitonic_out(ka, ia, k, kb, ib, vo, io, offset);
    return;
  }
  sort_desc(s, room, ka, ia, kb, ib, k);
  write_out(ka, ia, k, vo, io, offset);
}

// Stream g[0, count) into shared memory as keys; key e lands in slot
// e + sh, so that the 16-byte-aligned body of the scores lands on
// 16-byte-aligned slots.  Calls f(kk, ok) for every 4 keys as they
// arrive (ok[j]: kk[j] is a key); every lane calls f the same number of
// times.  Returns keys + sh.
template <typename T, typename F>
__device__ unsigned* load_keys(const T* g, int count, unsigned* keys, F f) {
  constexpr int V = Vec<T>::N;
  const int t = threadIdx.x;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15u);
  int head = static_cast<int>(((16 - mis) & 15) / sizeof(T));
  head = head < count ? head : count;
  const int sh = (4 - (head & 3)) & 3;
  const int nvec = (count - head) / V;
  const int tail = count - head - nvec * V;
  unsigned* slot = keys + sh;
  const uint4* body = reinterpret_cast<const uint4*>(g + head);
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
      unsigned kk[V] = {};
      if (ok) {
        Vec<T>::keys(buf[u], kk);
        uint4* dst = reinterpret_cast<uint4*>(slot + head + v * V);
#pragma unroll
        for (int j = 0; j < V / 4; ++j)
          dst[j] = make_uint4(kk[4 * j], kk[4 * j + 1], kk[4 * j + 2],
                              kk[4 * j + 3]);
      }
      const bool oks[4] = {ok, ok, ok, ok};
#pragma unroll
      for (int j = 0; j < V; j += 4) f(kk + j, oks);
    }
  }
  // the unaligned head and tail (fewer than 16 bytes each)
  int own = -1;
  if (t < head) own = t;
  else if (t - head < tail) own = head + nvec * V + (t - head);
  unsigned kk[4] = {0u, 0u, 0u, 0u};
  if (own >= 0) {
    kk[0] = key_of(f32_bits(g[own]));
    slot[own] = kk[0];
  }
  const bool oks[4] = {own >= 0, false, false, false};
  f(kk, oks);
  return slot;
}

// u32 of the resident route's row: the row (n keys and the alignment's
// up to 3 slots), once compacted the sort's second buffer (keys, then
// indices, max(k, SORT_SLOTS) each).
__host__ __device__ __forceinline__ long long resident_span(long long n,
                                                            long long k) {
  const long long sort = 2 * (k > SORT_SLOTS ? k : SORT_SLOTS);
  return n + 4 > sort ? n + 4 : sort;
}

// n rounded up to a multiple of 4 (16-byte alignment of u32 sections)
__host__ __device__ __forceinline__ long long round4(long long n) {
  return (n + 3) & ~3LL;
}

// The resident route: one block a row (dynamic shared memory:
// resident_bytes(n, k)).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
sel_resident(const T* __restrict__ x, int n, int k, float* __restrict__ vo,
             int32_t* __restrict__ io, int offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  unsigned* room = reinterpret_cast<unsigned*>(smem + ROOM_AT);
  unsigned* keys = reinterpret_cast<unsigned*>(smem + FIXED_BYTES);
  const int span = static_cast<int>(resident_span(n, k));
  unsigned* wk = keys + span;            // the winners, in row order
  unsigned* wi = wk + k;
  const long long row = blockIdx.x;
  for (int i = threadIdx.x; i < ROOM; i += THREADS) room[i] = 0u;
  if (threadIdx.x == 0) {
    s.lo = 0;
    s.hi = 0xffffffffu;
    s.need = k;
    s.cnt = n;
  }
  __syncthreads();
  const unsigned* slot = load_keys(
      x + row * n, n, keys, [&](const unsigned* kk, const bool* ok) {
        const unsigned d[4] = {kk[0] >> (32 - RES_BITS),
                               kk[1] >> (32 - RES_BITS),
                               kk[2] >> (32 - RES_BITS),
                               kk[3] >> (32 - RES_BITS)};
        hist_add4(room, d, ok);
      });
  pick_bin<RES_BINS>(s, room, 32 - RES_BITS);
  select_compact(s, room,
                 List{keys, static_cast<int>(slot - keys), n, nullptr, 0u},
                 RES_BITS, wk, wi);
  // the row's bytes are free: the sort's second buffer
  sort_out(s, room, wk, wi, keys, keys + span / 2, k, vo + row * k,
           io + row * k, offset);
}

// The long route, launch 1: a cluster a row counts the first digit and
// picks its bin; the row's state (scratch + row * stride): the bin's
// low key, the keys still wanted from it, its count, the keys above it.
template <typename T>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
sel_long_count(const T* __restrict__ x, long long n, int k,
               unsigned* __restrict__ scratch, long long stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* h = reinterpret_cast<unsigned*>(smem);
  unsigned* totals = h + LONG_BINS;      // the leader's: a slice's keys
  unsigned* warp_sum = totals + CLUSTER;
  constexpr int V = Vec<T>::N;
  cg::cluster_group cl = cg::this_cluster();
  const int r = static_cast<int>(cl.block_rank());
  const int t = threadIdx.x;
  const long long row = blockIdx.x / CLUSTER;
  for (int i = t; i < LONG_BINS / 4; i += THREADS)
    reinterpret_cast<uint4*>(h)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const T* g = x + row * n;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15u);
  long long head = ((16 - mis) & 15) / static_cast<int>(sizeof(T));
  head = head < n ? head : n;
  const long long nvec = (n - head) / V;
  const long long tail = n - head - nvec * V;
  const uint4* body = reinterpret_cast<const uint4*>(g + head);
  // this block's vectors: r, r + CLUSTER, ... in steps of THREADS * UNROLL
  for (long long v0 = static_cast<long long>(r) * THREADS * UNROLL;
       v0 < nvec; v0 += static_cast<long long>(CLUSTER) * THREADS * UNROLL) {
    uint4 buf[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + u * THREADS + t;
      if (v < nvec) buf[u] = __ldcs(body + v);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + u * THREADS + t;
      const bool ok = v < nvec;
      unsigned kk[V] = {};
      if (ok) Vec<T>::keys(buf[u], kk);
      const bool oks[4] = {ok, ok, ok, ok};
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const unsigned d[4] = {
            kk[j] >> (32 - LONG_BITS), kk[j + 1] >> (32 - LONG_BITS),
            kk[j + 2] >> (32 - LONG_BITS), kk[j + 3] >> (32 - LONG_BITS)};
        hist_add4(h, d, oks);
      }
    }
  }
  if (r == 0) {                          // the unaligned head and tail
    long long own = -1;
    if (t < head) own = t;
    else if (t - head < tail) own = head + nvec * V + (t - head);
    const unsigned key = own >= 0 ? key_of(f32_bits(g[own])) : 0u;
    hist_add(h, key >> (32 - LONG_BITS), own >= 0);
  }
  cl.sync();
  // block r sums slice r of every block's histogram into its own
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int b = 0; b < CLUSTER; ++b) {
    const uint4 v = reinterpret_cast<const uint4*>(
        cl.map_shared_rank(h, b) + r * SLICE)[t];
    acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
  }
  reinterpret_cast<uint4*>(h + r * SLICE)[t] = acc;
  const unsigned total =
      block_sum(warp_sum, acc.x + acc.y + acc.z + acc.w);
  if (t == 0) cl.map_shared_rank(totals, 0)[r] = total;
  cl.sync();
  // the slice that holds the k-th largest key (higher slices first)
  const unsigned* lead = cl.map_shared_rank(totals, 0);
  unsigned above = 0;
  for (int b = CLUSTER - 1; b > r; --b) above += lead[b];
  const unsigned here = lead[r];
  cl.sync();                             // the leader's totals are read
  const unsigned need = static_cast<unsigned>(k);
  if (!(above < need && above + here >= need)) return;
  // thread t holds the slice's bins top - 4t - j, top bins first
  const uint4 q = reinterpret_cast<const uint4*>(
      h + r * SLICE + SLICE - 4 * (t + 1))[0];
  const unsigned v[4] = {q.w, q.z, q.y, q.x};
  unsigned up = above +
                block_exclusive(warp_sum, v[0] + v[1] + v[2] + v[3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (up < need && up + v[j] >= need) {
      unsigned* st = scratch + row * stride;
      st[0] = static_cast<unsigned>(r * SLICE + SLICE - 1 - 4 * t - j)
              << (32 - LONG_BITS);
      st[1] = need - up;
      st[2] = v[j];
      st[3] = up;
    }
    up += v[j];
  }
}

// The long route, launch 2: one block per (row, tile of LTILE scores)
// writes its keys above the row's bin and its largest min(bin keys,
// need) bin keys, in row order, to the tile's region of scratch (keys,
// then indices, cap = min(LTILE, k) rounded up to 4, each), and the
// tile's line: its keys above the bin, the bin keys it kept, and the
// least and the largest key of its bin (0xffffffff and 0 for none).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
sel_long_tiles(const T* __restrict__ x, long long n, int tiles, int cap,
               unsigned* __restrict__ scratch, long long stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  unsigned* room = reinterpret_cast<unsigned*>(smem + ROOM_AT);
  unsigned* keys = reinterpret_cast<unsigned*>(smem + FIXED_BYTES);
  const long long row = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x - row * tiles);
  const long long first = static_cast<long long>(tile) * LTILE;
  const int count = static_cast<int>(n - first < LTILE ? n - first : LTILE);
  unsigned* st = scratch + row * stride;
  const unsigned lo = st[0], need = st[1];
  const unsigned hi = lo | ((1u << (32 - LONG_BITS)) - 1u);
  for (int i = threadIdx.x; i < ROOM; i += THREADS) room[i] = 0u;
  if (threadIdx.x == 0) {
    s.mn = 0xffffffffu;
    s.mx = 0u;
  }
  __syncthreads();
  // the tile's keys in the bin (how many, the least and the largest)
  // and above it (are there any)
  unsigned inb = 0, mn = 0xffffffffu, mx = 0u;
  bool above = false;
  const unsigned* slot = load_keys(
      x + row * n + first, count, keys,
      [&](const unsigned* kk, const bool* ok) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          above |= ok[e] && kk[e] > hi;
          if (ok[e] && kk[e] >= lo && kk[e] <= hi) {
            ++inb;
            mn = min(mn, kk[e]);
            mx = max(mx, kk[e]);
          }
        }
      });
  bin_extremes(s, mn, mx);
  const bool none_above = !__syncthreads_or(above);
  const unsigned bin = block_sum(s.warp_sum, inb);
  const unsigned kept = bin < need ? bin : need;
  const unsigned bmn = s.mn, bmx = s.mx;
  if (threadIdx.x == 0) {
    // a bin of one key value is its own k-th key
    s.lo = bin && bmn == bmx ? bmn : lo;
    s.hi = bin && bmn == bmx ? bmn : hi;
    s.cnt = static_cast<int>(bin);
    s.need = static_cast<int>(kept);
  }
  unsigned* rk = st + STATE + LINE * tiles +
                 static_cast<long long>(tile) * cap;
  unsigned* ri = rk + static_cast<long long>(tiles) * cap;
  const int c = select_compact(
      s, room,
      List{keys, static_cast<int>(slot - keys), count, nullptr,
           static_cast<unsigned>(first)},
      LONG_BITS, rk, ri, none_above && bin && bmn == bmx);
  if (threadIdx.x == 0) {
    unsigned* line = st + STATE + LINE * tile;
    line[0] = static_cast<unsigned>(c) - kept;
    line[1] = kept;
    line[2] = bmn;
    line[3] = bmx;
  }
}

// The long route, launch 3: one block a row gathers the tiles' keys in
// order and selects and sorts the k winners, in shared memory when the
// candidates and the winners fit (dynamic shared memory: RESIDENT_SMEM),
// else in scratch (the candidates gathered after the regions, the
// winners after them).  When the row's bin holds one key value, its
// winners are the first `need` bin keys in row order, so the gather
// takes the keys above the bin and those alone: k keys.
__global__ void __launch_bounds__(THREADS, 1)
sel_long_final(int k, int tiles, int cap, unsigned* __restrict__ scratch,
               long long stride, float* __restrict__ vo,
               int32_t* __restrict__ io, int offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  unsigned* room = reinterpret_cast<unsigned*>(smem + ROOM_AT);
  unsigned* buf = reinterpret_cast<unsigned*>(smem + FIXED_BYTES);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const long long row = blockIdx.x;
  unsigned* st = scratch + row * stride;
  const unsigned lo = st[0], need = st[1];
  const unsigned hi = lo | ((1u << (32 - LONG_BITS)) - 1u);
  const unsigned* lines = st + STATE;
  const long long region = static_cast<long long>(tiles) * cap;
  const unsigned* rk = lines + LINE * tiles;
  const unsigned* ri = rk + region;
  unsigned* gk = const_cast<unsigned*>(ri) + region;
  unsigned* gi = gk + region;
  unsigned* ak = gi + region;
  unsigned* ai = ak + k;
  // the candidates, and whether the row's bin is one key value
  if (t == 0) {
    s.mn = 0xffffffffu;
    s.mx = 0u;
  }
  __syncthreads();
  unsigned m = 0, kept = 0, mn = 0xffffffffu, mx = 0u;
  for (int j = t; j < tiles; j += THREADS) {
    const unsigned* l = lines + LINE * j;
    m += l[0] + l[1];
    kept += l[1];
    mn = min(mn, l[2]);
    mx = max(mx, l[3]);
  }
  bin_extremes(s, mn, mx);
  m = block_sum(s.warp_sum, m);
  kept = block_sum(s.warp_sum, kept);
  const bool one = kept > 0 && s.mn == s.mx;
  const int M = static_cast<int>(one ? k : m);
  const long long span = M > SORT_SLOTS ? M : SORT_SLOTS;
  const bool in_smem = FIXED_BYTES + 8 * (span + k) <= RESIDENT_SMEM;
  unsigned* dk = in_smem ? buf : gk;
  unsigned* di = in_smem ? buf + span : gi;
  unsigned* wk = in_smem ? buf + 2 * span : ak;
  unsigned* wi = in_smem ? wk + k : ai;
  // gather the regions in order, a warp a tile: each tile's keys above
  // the bin and its first `quota` bin keys (all of them unless one)
  unsigned run = 0, bins = 0;
  for (int c0 = 0; c0 < tiles; c0 += THREADS) {
    const int j = c0 + t;
    const unsigned* l = lines + LINE * (j < tiles ? j : 0);
    const unsigned g = j < tiles ? l[0] : 0u, b = j < tiles ? l[1] : 0u;
    const unsigned bb = block_exclusive(s.warp_sum, b);
    __syncthreads();
    const unsigned left = need > bins + bb ? need - (bins + bb) : 0u;
    const unsigned quota = one ? (b < left ? b : left) : b;
    const unsigned before = block_exclusive(s.warp_sum, g + quota);
    room[t] = run + before;
    room[THREADS + t] = quota;
    room[2 * THREADS + t] = g;
    room[3 * THREADS + t] = g + b;
    if (t == THREADS - 1) {
      s.above[0] = before + g + quota;
      s.above[1] = bb + b;
    }
    __syncthreads();
    const int nt = tiles - c0 < THREADS ? tiles - c0 : THREADS;
    for (int jj = warp; jj < nt; jj += WARPS) {
      const unsigned p = room[jj], q = room[THREADS + jj];
      const unsigned gts = room[2 * THREADS + jj];
      const unsigned cc = room[3 * THREADS + jj];
      const long long from = static_cast<long long>(c0 + jj) * cap;
      unsigned put = 0, seen_bin = 0, seen_gt = 0;
      for (unsigned e0 = 0; e0 < cc && (seen_bin < q || seen_gt < gts);
           e0 += 32 * WALK) {
        unsigned kk[WALK], ii[WALK];
#pragma unroll
        for (int u = 0; u < WALK; ++u) {
          const unsigned e = e0 + u * 32 + lane;
          kk[u] = e < cc ? rk[from + e] : 0u;
          ii[u] = e < cc ? ri[from + e] : 0u;
        }
#pragma unroll
        for (int u = 0; u < WALK; ++u) {
          const bool in = e0 + u * 32 + lane < cc;
          const bool is_bin = in && kk[u] <= hi;
          const unsigned bal = __ballot_sync(FULL, is_bin);
          const bool take =
              in && (!is_bin || seen_bin + __popc(bal & lt) < q);
          const unsigned tb = __ballot_sync(FULL, take);
          if (take) {
            dk[p + put + __popc(tb & lt)] = kk[u];
            di[p + put + __popc(tb & lt)] = ii[u];
          }
          put += __popc(tb);
          seen_bin += __popc(bal);
          seen_gt += __popc(__ballot_sync(FULL, in && !is_bin));
        }
      }
    }
    run += s.above[0];
    bins += s.above[1];
    __syncthreads();
  }
  for (int i = t; i < ROOM; i += THREADS) room[i] = 0u;
  __syncthreads();
  if (t == 0) {
    // a bin of one key value is its own k-th key
    s.lo = one ? s.mn : lo;
    s.hi = one ? s.mn : hi;
    s.need = static_cast<int>(need);
    s.cnt = one ? static_cast<int>(need) : static_cast<int>(kept);
  }
  select_compact(s, room, List{dk, 0, M, di, 0u}, LONG_BITS, wk, wi);
  // the candidates' space is free: the sort's second buffer
  sort_out(s, room, wk, wi, dk, di, k, vo + row * k, io + row * k, offset);
}

// The sort alone, for timing it at a path's k: one block a row sorts
// the row's k (key, index) pairs, given in row order, as the resident
// and final launches do, from shared memory (dynamic shared memory:
// FIXED_BYTES + 16 max(k, SORT_SLOTS)).
__global__ void __launch_bounds__(THREADS, 1)
sel_sort_only(const unsigned* __restrict__ keys,
              const unsigned* __restrict__ idx, int k,
              float* __restrict__ vo, int32_t* __restrict__ io) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  unsigned* room = reinterpret_cast<unsigned*>(smem + ROOM_AT);
  const int span = k > SORT_SLOTS ? k : SORT_SLOTS;
  unsigned* ka = reinterpret_cast<unsigned*>(smem + FIXED_BYTES);
  unsigned* ia = ka + span;
  const long long row = blockIdx.x;
  for (int i = threadIdx.x; i < k; i += THREADS) {
    ka[i] = keys[row * k + i];
    ia[i] = idx[row * k + i];
  }
  sort_out(s, room, ka, ia, ia + span, ia + 2 * span, k, vo + row * k,
           io + row * k, 0);
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Shared memory of the resident route for a row of n scores at k: the
// state and the room, the row (or, once compacted, the sort's second
// buffer of k keys and k indices), the k winners as keys and indices.
long long resident_bytes(long long n, long long k) {
  return FIXED_BYTES + 4 * resident_span(n, k) + 8 * k;
}

// The plan of a row of n scores at k (kernels/topk/topk.py::plan, the
// select routes): resident when resident_bytes fits RESIDENT_SMEM, with
// no tiles and no scratch; else long, with ceil(n / LTILE) tiles and
// int64 scratch words a row (a multiple of 16 bytes) for the state, the
// tiles' lines (4 u32 each), their regions (keys and indices, min(LTILE, k) each,
// rounded up to 4), the gathered candidates (as large) and k winners
// (keys and indices).
bool make_plan(long long n, long long k, long long* tiles, long long* words) {
  if (k <= MAX_K || k > n || n > 0x7fffffffLL) return false;
  if (resident_bytes(n, k) <= RESIDENT_SMEM) {
    *tiles = 0;
    *words = 0;
    return true;
  }
  *tiles = cdiv(n, LTILE);
  const long long cap = round4(k < LTILE ? k : LTILE);
  *words = 2 * cdiv(STATE + LINE * *tiles + 4 * *tiles * cap + 2 * k, 4);
  return true;
}

// Raise a kernel's dynamic shared memory limit, once per device.
cudaError_t allow_smem(const void* kernel, int bytes, int* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = 1;
  return err;
}

template <typename T>
int launch_select(const void* x, long long rows, long long n, int k,
                  int offset, long long tiles, void* scratch, void* vo,
                  void* io, void* stream) {
  static int done_res[64], done_count[64], done_tiles[64], done_final[64];
  if (rows <= 0) return 0;
  // the wrapper's plan must be this launcher's
  long long want_tiles, words;
  if (!make_plan(n, k, &want_tiles, &words) || tiles != want_tiles ||
      (words > 0 && scratch == nullptr) || rows > 0x7fffffffLL / CLUSTER ||
      rows * (tiles > 0 ? tiles : 1) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xs = static_cast<const T*>(x);
  float* v = static_cast<float*>(vo);
  int32_t* ix = static_cast<int32_t*>(io);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tiles == 0) {                      // resident: one launch
    err = allow_smem(reinterpret_cast<const void*>(sel_resident<T>),
                     RESIDENT_SMEM, done_res);
    if (err != cudaSuccess) return static_cast<int>(err);
    sel_resident<T><<<static_cast<unsigned>(rows), THREADS,
                      resident_bytes(n, k), st>>>(
        xs, static_cast<int>(n), k, v, ix, offset);
    return static_cast<int>(cudaGetLastError());
  }
  unsigned* sc = static_cast<unsigned*>(scratch);
  const long long stride = 2 * words;
  const int cap = static_cast<int>(round4(k < LTILE ? k : LTILE));
  err = allow_smem(reinterpret_cast<const void*>(sel_long_count<T>),
                   COUNT_BYTES, done_count);
  if (err != cudaSuccess) return static_cast<int>(err);
  sel_long_count<T><<<static_cast<unsigned>(rows * CLUSTER), THREADS,
                      COUNT_BYTES, st>>>(xs, n, k, sc, stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(reinterpret_cast<const void*>(sel_long_tiles<T>),
                   TILE_BYTES, done_tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  sel_long_tiles<T><<<static_cast<unsigned>(rows * tiles), THREADS,
                      TILE_BYTES, st>>>(xs, n, static_cast<int>(tiles), cap,
                                        sc, stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(reinterpret_cast<const void*>(sel_long_final),
                   RESIDENT_SMEM, done_final);
  if (err != cudaSuccess) return static_cast<int>(err);
  sel_long_final<<<static_cast<unsigned>(rows), THREADS, RESIDENT_SMEM,
                   st>>>(k, static_cast<int>(tiles), cap, sc, stride, v, ix,
                         offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The select routes' plan of a row of n scores at k: out[0] tiles (0:
// the resident route), out[1] int64 scratch words a row;
// cudaErrorInvalidValue where no select route takes the request (k <=
// MAX_K, k > n).
extern "C" int repro_topk_select_plan(long long n, int k, long long* out) {
  if (!make_plan(n, k, &out[0], &out[1]))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The sort of the select routes alone (not a path's launch: chip_smoke.py
// times it): rows of k (key, index) pairs in row order; the keys are
// total-order keys of f32 scores.  cudaErrorInvalidValue where the pairs
// do not fit one block's shared memory.
extern "C" int repro_topk_select_sort(const void* keys, const void* idx,
                                      long long rows, int k, void* vo,
                                      void* io, void* stream) {
  static int done[64];
  const long long span = k > SORT_SLOTS ? k : SORT_SLOTS;
  const long long bytes = FIXED_BYTES + 16 * span;
  if (rows <= 0 || rows > 0x7fffffffLL || k <= MAX_K ||
      bytes > RESIDENT_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(sel_sort_only),
                               RESIDENT_SMEM, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  sel_sort_only<<<static_cast<unsigned>(rows), THREADS, bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(keys), static_cast<const unsigned*>(idx),
      k, static_cast<float*>(vo), static_cast<int32_t*>(io));
  return static_cast<int>(cudaGetLastError());
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
