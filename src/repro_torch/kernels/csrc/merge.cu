// Score-list merge (Merge-and-Backward phase) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/merge/merge.py::merge_pallas (body
// _merge_kernel, network _bitonic_descending): the top-k of the union of
// two descending k-lists of (score, owner) couples, with optional
// per-row validity masks that turn a whole list into -inf.
//
// Bound: device-memory bytes.  A row pair reads 2k values and 2k int32
// owners and writes k of each (36 k bytes in f64, 24 k in f32, 18 k in
// bf16, plus a mask byte a list); ranking an element costs log2(k) + 1
// compares, far below what the card's memory rate leaves time for.
//
// Merge by rank instead of the TPU kernel's bitonic network.  Both inputs
// are sorted descending in the total order of Num<T>::key (the sweep's
// lists come from the order-statistics draw padded with -inf tails, the
// collectives' from the top-k kernel, and every merge preserves the
// order), so each element's output position is known directly:
//   a[j] goes to j + #{b > a[j]},   b[l] goes to l + #{a >= b[l]},
// each count a binary search over the other row's keys, and an element
// is written only when that position is < k.  This is exactly the stable
// tie rule of the plain version (list a first, then the lower position)
// and uses compare and select only, so f64 stays bit-exact.
//
// What held the first design (one thread an element) below its bound: it
// was bound by latency, not bandwidth.  (1) Each thread loaded one value
// and one owner, so an SM had at most 2,048 x 12 bytes (f64), 8 (f32) or
// 6 (bf16) of loads in flight, less than hiding the memory's latency
// takes, and its time barely fell with the element size.  (2) Loads were
// issued only at a block's start; then the block waited at a barrier and
// ran the dependent shared-memory reads of its searches with nothing in
// flight.  (3) A bf16 warp load covered 64 bytes.  (4) Each output row
// was written as scattered partial-sector stores.
//
// Three routes; the wrapper (kernels/merge/merge.py::merge_plan) chooses,
// make_plan below recomputes the plan and the launcher refuses any other.
//
//   bulk: the sweep's K = 32 (BULK_K, the one list length the ring was
//     measured at).  Persistent blocks, grid = min(tiles, SMS x the blocks
//     an SM holds), each walking the row tiles blockIdx.x, + gridDim.x, ...
//     A tile of R rows is one contiguous span of R*32 elements in each of
//     va, ia, vb and ib.  One thread copies it with four TMA 1-D bulk
//     copies into one stage of a ring of STAGES in shared memory,
//     completing on that stage's mbarrier, STAGES tiles ahead of the tile
//     being merged (every span, the ragged last tile's too, is a multiple
//     of 64 bytes).  R makes a stage STAGE_BYTES whatever the element
//     size, so the bytes in flight an SM (blocks x stages x STAGE_BYTES)
//     no longer depend on it and loads never wait for a block's start (1,
//     2, 3).  A warp ranks a row pair at a time, lane l holding a[l] and
//     b[l], by warp shuffles over the other list's keys in registers.  The
//     merged rows go to a shared output tile in order, and one TMA bulk
//     store writes it: whole sectors, each output byte once (4).  Masks are
//     read a tile ahead, one byte a thread.
//   direct: one block a tile, read and written in place.  For
//     16 < k <= 32 from WARP_MIN_ROWS rows a warp takes a row pair, two
//     elements a lane (coalesced loads), ranked by warp shuffles with no
//     shared memory and no barrier; otherwise it is the first design,
//     unchanged: one thread an element, THREADS / 2k rows a block.  It
//     is the route for every k but 32, where a base is off 16 bytes, where
//     a launch is too small for the ring to pay (fewer than BULK_MIN_ROWS
//     rows), and where its own loads keep enough bytes in flight (K = 32
//     in f64: 2,048 threads x 24 bytes an SM).
//   row: k > MAX_TILE_K, where a row pair does not fit a block: one block
//     a row pair (grid-stride), each output's position by the same search
//     over the other list, read from device memory / L2.
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

constexpr int THREADS = 256;            // a block's threads, every route
constexpr int MAX_TILE_K = 512;         // longest list a block holds
constexpr int BULK_K = 32;              // the one list length of the ring
constexpr int STAGE_BYTES = 12288;      // a bulk stage: the four lists of a tile
constexpr int STAGES = 3;               // tiles a bulk block has in flight
constexpr int SMS = 132;                // the H100's SMs
constexpr int SM_SMEM = 233472;         // an SM's shared memory
constexpr int SMEM_RESERVED = 1024;     // shared memory the card keeps a block
constexpr int SMEM_MAX = 232448;        // a block's dynamic shared memory
constexpr int BULK_BLOCKS = 4;          // bulk blocks an SM holds at most
constexpr int ROW_BLOCKS = 8;           // row-route blocks an SM holds
constexpr int SM_THREADS = 2048;        // threads an SM holds
// The ring pays where the direct route keeps fewer bytes in flight an SM
// than DIRECT_INFLIGHT (its loads over SM_THREADS threads: 48 KB at K = 32
// in f64 saturates the memory on the H100, 32 KB in f32 and 24 KB in
// bf16 do not) and the launch has BULK_MIN_ROWS rows (below them the
// direct route's shorter chain wins; tools/merge_levels.py).
constexpr int DIRECT_INFLIGHT = 40960;
constexpr int BULK_MIN_ROWS = 96000;
// A direct launch of 16 < k <= 32 takes a warp a row pair from
// WARP_MIN_ROWS rows; below them the first design's launch is 50-180 ns
// faster on the H100 (tools/merge_levels.py).
constexpr int WARP_MIN_ROWS = 2048;
constexpr int ALIGN = 16;               // a bulk copy's address and size

enum Route : int { kBulk = 0, kDirect = 1, kRow = 2 };

// The launch plan (kernels/merge/merge.py::MergePlan, same fields).
struct Plan {
  long long route, rows_per_tile, ept, stages, threads, tiles, grid, smem;
};

__host__ __device__ constexpr long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

__host__ __device__ constexpr long long round16(long long x) {
  return cdiv(x, ALIGN) * ALIGN;
}

// Rows of a bulk tile: a stage of STAGE_BYTES (16, 24 and 32 rows in f64,
// f32 and bf16); every span of a tile, or of fewer rows, is a multiple of
// 64 bytes.
constexpr long long bulk_rows(int itemsize) {
  return STAGE_BYTES / (itemsize + 4) / (2 * BULK_K);
}

// Shared memory of a bulk block: the ring (va, ia, vb, ib a stage), the
// output tile (values, owners), the masks and one mbarrier a stage, in
// that order.
constexpr long long bulk_smem(int itemsize) {
  const long long n = bulk_rows(itemsize) * BULK_K;
  return STAGES * 2 * n * (itemsize + 4) + n * (itemsize + 4) +
         round16(2 * bulk_rows(itemsize)) + 8LL * STAGES;
}

// The direct route takes a row pair a warp
constexpr bool warp_rows(long long rows, long long k) {
  return k > 16 && k <= 32 && rows >= WARP_MIN_ROWS;
}

// The plan of a merge of `rows` row pairs of k-lists of `itemsize`-byte
// values, or false when the request cannot be planned.  `aligned`: the
// six list bases are 16-byte aligned.  route: kBulk, kDirect or kRow,
// or -1 for the plan's choice: row where k > MAX_TILE_K, bulk where k is
// BULK_K, the bases aligned, the launch has BULK_MIN_ROWS rows and a
// direct launch would keep fewer than DIRECT_INFLIGHT bytes in flight an
// SM (f32 and bf16), else direct.
bool make_plan(long long rows, long long k, int itemsize, bool aligned,
               int route, Plan* p) {
  if (rows <= 0 || k <= 0 || route < -1 || route > kRow ||
      (itemsize != 2 && itemsize != 4 && itemsize != 8))
    return false;
  const bool fits = k <= MAX_TILE_K;
  const bool bulk_ok = aligned && k == BULK_K;
  // bytes a direct launch of K = 32 keeps in flight an SM: a row pair a warp
  const long long inflight = SM_THREADS / 32 * 2 * BULK_K * (itemsize + 4);
  if (route < 0)
    route = !fits ? kRow
            : bulk_ok && rows >= BULK_MIN_ROWS && inflight < DIRECT_INFLIGHT
                ? kBulk
                : kDirect;
  if ((route == kBulk && !bulk_ok) || (route == kDirect && !fits))
    return false;
  long long blocks;
  p->route = route;
  p->threads = THREADS;
  if (route == kBulk) {
    p->rows_per_tile = bulk_rows(itemsize);
    p->ept = 2 * BULK_K * p->rows_per_tile / THREADS;
    p->stages = STAGES;
    p->smem = bulk_smem(itemsize);
    blocks = SM_SMEM / (p->smem + SMEM_RESERVED);
    if (blocks > BULK_BLOCKS) blocks = BULK_BLOCKS;
  } else if (route == kDirect) {
    p->stages = 0;
    blocks = -1;  // one block a tile
    if (warp_rows(rows, k)) {
      // a warp a row pair, two elements a lane
      p->rows_per_tile = THREADS / 32;
      p->ept = 2;
      p->smem = 0;
    } else {
      // one thread an element: as many rows a block as THREADS threads
      // hold, or one row of 2k threads where that is more
      p->rows_per_tile = 2 * k >= THREADS ? 1 : THREADS / (2 * k);
      p->ept = 1;
      p->threads = 2 * k * p->rows_per_tile;
      p->smem = p->threads * (itemsize == 8 ? 8 : 4);
    }
  } else {
    p->rows_per_tile = 1;
    p->ept = 0;
    p->stages = 0;
    p->smem = 0;
    blocks = ROW_BLOCKS;
  }
  p->tiles = cdiv(rows, p->rows_per_tile);
  p->grid = blocks < 0 || p->tiles < SMS * blocks ? p->tiles : SMS * blocks;
  return p->smem <= SMEM_MAX && p->grid < (1LL << 31);
}

// ---------------------------------------------------------------------------
// TMA bulk copies and mbarriers (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, completing `bytes` on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, in the thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have all read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the threads' shared-memory writes are visible to bulk copies
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// the bulk route
// ---------------------------------------------------------------------------

// Block b merges tiles b, b + gridDim.x, ... of R rows of BULK_K.  Per
// tile: (1) a warp takes a row pair at a time, lane l reading a[l] and
// b[l] and their owners from the tile's stage, masked and keyed; barrier;
// (2) the tile STAGES ahead is copied into the freed stage and the next
// tile's masks are stored; (3) each element's count is found by binary
// lifting over the other list's keys by warp shuffles, the keys never
// leaving registers, and the element placed at l + count, when that is
// < BULK_K, in the output tile; barrier; one bulk store.  EPT = R / 4:
// the elements a thread ranks, two a row.
template <typename T, int EPT>
__global__ void __launch_bounds__(THREADS, BULK_BLOCKS)
merge_kernel(const T* __restrict__ va, const int32_t* __restrict__ ia,
             const T* __restrict__ vb, const int32_t* __restrict__ ib,
             const uint8_t* __restrict__ ma, const uint8_t* __restrict__ mb,
             T* __restrict__ vo, int32_t* __restrict__ io, long long rows,
             long long tiles) {
  using Key = typename Num<T>::Key;
  constexpr int SZ = static_cast<int>(sizeof(T));
  constexpr int K = BULK_K;
  constexpr int WARPS = THREADS / 32;
  constexpr int RPW = EPT / 2;          // rows a warp takes in a tile
  constexpr int R = WARPS * RPW;
  constexpr int n = R * K;              // elements of one list in a tile
  constexpr int stage_bytes = 2 * n * (SZ + 4);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  T* out_v = reinterpret_cast<T*>(smem + STAGES * stage_bytes);
  int32_t* out_i = reinterpret_cast<int32_t*>(smem + STAGES * stage_bytes + n * SZ);
  uint8_t* masks = smem + STAGES * stage_bytes + n * (SZ + 4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(masks + round16(2 * R));
  const long long step = gridDim.x;

  // one mask byte a thread, a tile ahead: list tid / R, row tid % R
  auto mask_of = [&](long long t) -> uint8_t {
    if (tid >= 2 * R || t >= tiles) return 1;
    const bool a = tid < R;
    const uint8_t* m = a ? ma : mb;
    const long long row = t * R + (a ? tid : tid - R);
    return (m == nullptr || row >= rows) ? 1 : m[row];
  };
  // copy tile t into stage s (thread 0)
  auto issue = [&](long long t, int s) {
    const long long row0 = t * R;
    const long long nr = rows - row0 < R ? rows - row0 : R;
    const uint32_t bv = static_cast<uint32_t>(nr * K * SZ);
    const uint32_t bi = static_cast<uint32_t>(nr * K * 4);
    unsigned char* st = smem + s * stage_bytes;
    mbar_expect(bars + s, 2 * (bv + bi));
    bulk_load(st, va + row0 * K, bv, bars + s);
    bulk_load(st + n * SZ, ia + row0 * K, bi, bars + s);
    bulk_load(st + n * (SZ + 4), vb + row0 * K, bv, bars + s);
    bulk_load(st + n * (2 * SZ + 4), ib + row0 * K, bi, bars + s);
  };

  long long t = blockIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // the ring fills before the first masks are read
  if (tid == 0)
    for (int s = 0; s < STAGES; ++s)
      if (t + s * step < tiles) issue(t + s * step, s);
  if (tid < 2 * R) masks[tid] = mask_of(t);
  uint8_t mnext = mask_of(t + step);
  __syncthreads();

  for (int i = 0; t < tiles; ++i, t += step) {
    const long long row0 = t * R;
    const int nrows = static_cast<int>(rows - row0 < R ? rows - row0 : R);
    const int s = i % STAGES;
    const unsigned char* st = smem + s * stage_bytes;
    const T* sva = reinterpret_cast<const T*>(st);
    const int32_t* sia = reinterpret_cast<const int32_t*>(st + n * SZ);
    const T* svb = reinterpret_cast<const T*>(st + n * (SZ + 4));
    const int32_t* sib = reinterpret_cast<const int32_t*>(st + n * (2 * SZ + 4));
    mbar_wait(bars + s, (i / STAGES) & 1);

    // (1) warp w takes rows w, w + WARPS, ... of the tile (rows past a
    // ragged tile's end hold stale stage bytes and are not written)
    T xa[RPW], xb[RPW];
    int32_t oa[RPW], ob[RPW];
    Key ka[RPW], kb[RPW];
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const int off = (warp + q * WARPS) * K + lane;
      xa[q] = sva[off];
      oa[q] = sia[off];
      xb[q] = svb[off];
      ob[q] = sib[off];
      if (masks[warp + q * WARPS] == 0) xa[q] = Num<T>::neg_inf();
      if (masks[R + warp + q * WARPS] == 0) xb[q] = Num<T>::neg_inf();
      ka[q] = Num<T>::key(xa[q]);
      kb[q] = Num<T>::key(xb[q]);
    }
    if (tid == 0) bulk_wait_read();  // the last store has read out_*
    __syncthreads();
    // (2) stage s is read: refill it, pass the next tile's masks
    if (tid == 0 && t + STAGES * step < tiles) issue(t + STAGES * step, s);
    if (tid < 2 * R) masks[tid] = mnext;
    mnext = mask_of(t + 2 * step);
    // (3) a[l] counts b > a[l], b[l] counts a >= b[l]: binary lifting,
    // lo + half - 1 < 32 at every step, then one compare at lo
    int la[RPW], lb[RPW];
#pragma unroll
    for (int q = 0; q < RPW; ++q) la[q] = lb[q] = 0;
#pragma unroll
    for (int half = 16; half > 0; half >>= 1) {
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        const Key ya = __shfl_sync(0xffffffffu, kb[q], la[q] + half - 1);
        const Key yb = __shfl_sync(0xffffffffu, ka[q], lb[q] + half - 1);
        if (ya > ka[q]) la[q] += half;
        if (yb >= kb[q]) lb[q] += half;
      }
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const Key ya = __shfl_sync(0xffffffffu, kb[q], la[q]);
      const Key yb = __shfl_sync(0xffffffffu, ka[q], lb[q]);
      if (ya > ka[q]) la[q] += 1;
      if (yb >= kb[q]) lb[q] += 1;
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const int r = warp + q * WARPS;
      const int pa = lane + la[q];
      const int pb = lane + lb[q];
      if (r < nrows) {
        if (pa < K) {
          out_v[r * K + pa] = xa[q];
          out_i[r * K + pa] = oa[q];
        }
        if (pb < K) {
          out_v[r * K + pb] = xb[q];
          out_i[r * K + pb] = ob[q];
        }
      }
    }
    // the output tile is whole: one thread stores it
    fence_to_async();
    __syncthreads();
    if (tid == 0) {
      bulk_store(vo + row0 * K, out_v, static_cast<uint32_t>(nrows * K * SZ));
      bulk_store(io + row0 * K, out_i, static_cast<uint32_t>(nrows * K * 4));
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_read();
}

// ---------------------------------------------------------------------------
// the direct route
// ---------------------------------------------------------------------------

// The warp direct launch (16 < k <= 32): a warp a row pair, lane l < k
// loading a[l] and b[l] (coalesced, with their owners, after the row's
// mask bytes) and ranking both by warp shuffles over the other list's
// keys, as the bulk route does; no shared memory and no barrier.  KC = 32: k known, a power of two, the search needs no bounds
// test.
template <typename T, int KC>
__global__ void __launch_bounds__(THREADS)
merge_kernel_warp(const T* __restrict__ va, const int32_t* __restrict__ ia,
                  const T* __restrict__ vb, const int32_t* __restrict__ ib,
                  const uint8_t* __restrict__ ma,
                  const uint8_t* __restrict__ mb, T* __restrict__ vo,
                  int32_t* __restrict__ io, long long rows, int k_arg) {
  using Key = typename Num<T>::Key;
  const int k = KC > 0 ? KC : k_arg;
  const long long row =
      static_cast<long long>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const bool on = KC == 32 || lane < k;
  const uint8_t ok_a = ma == nullptr ? 1 : ma[row];
  const uint8_t ok_b = mb == nullptr ? 1 : mb[row];
  const long long g = row * k + lane;
  T xa = Num<T>::neg_inf();
  T xb = Num<T>::neg_inf();
  int32_t oa = 0;
  int32_t ob = 0;
  if (on) {
    xa = va[g];
    xb = vb[g];
    oa = ia[g];
    ob = ib[g];
  }
  if (ok_a == 0) xa = Num<T>::neg_inf();
  if (ok_b == 0) xb = Num<T>::neg_inf();
  const Key ka = Num<T>::key(xa);
  const Key kb = Num<T>::key(xb);
  // a[l] counts b > a[l], b[l] counts a >= b[l]: binary lifting over
  // the other list's first k lanes
  int la = 0;
  int lb = 0;
  if constexpr (KC == 32) {
    // lo + half - 1 < 32 at every step, then one compare at lo
#pragma unroll
    for (int half = 16; half > 0; half >>= 1) {
      const Key ya = __shfl_sync(0xffffffffu, kb, la + half - 1);
      const Key yb = __shfl_sync(0xffffffffu, ka, lb + half - 1);
      if (ya > ka) la += half;
      if (yb >= kb) lb += half;
    }
    const Key ya = __shfl_sync(0xffffffffu, kb, la);
    const Key yb = __shfl_sync(0xffffffffu, ka, lb);
    if (ya > ka) la += 1;
    if (yb >= kb) lb += 1;
  } else {
    // k < 32: counts below 32, steps 16 .. 1 with a bounds test
#pragma unroll
    for (int half = 16; half > 0; half >>= 1) {
      const int pa = la + half;
      const int pb = lb + half;
      const Key ya = __shfl_sync(0xffffffffu, kb, (pa <= k ? pa : k) - 1);
      const Key yb = __shfl_sync(0xffffffffu, ka, (pb <= k ? pb : k) - 1);
      if (pa <= k && ya > ka) la = pa;
      if (pb <= k && yb >= kb) lb = pb;
    }
  }
  const long long o = row * k;
  if (on && lane + la < k) {
    vo[o + lane + la] = xa;
    io[o + lane + la] = oa;
  }
  if (on && lane + lb < k) {
    vo[o + lane + lb] = xb;
    io[o + lane + lb] = ob;
  }
}

// Every other direct launch: the first design, unchanged, one thread an
// element.

template <typename T>
__global__ void merge_kernel_direct(const T* __restrict__ va,
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

// ---------------------------------------------------------------------------
// the row route: k > MAX_TILE_K
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
merge_kernel_rows(const T* __restrict__ va, const int32_t* __restrict__ ia,
                  const T* __restrict__ vb, const int32_t* __restrict__ ib,
                  const uint8_t* __restrict__ ma,
                  const uint8_t* __restrict__ mb, T* __restrict__ vo,
                  int32_t* __restrict__ io, long long rows, int k) {
  using Key = typename Num<T>::Key;
  int top = 1;
  while (2 * top <= k) top *= 2;
  const Key kinf = Num<T>::key(Num<T>::neg_inf());
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const bool ok_a = ma == nullptr || ma[row] != 0;
    const bool ok_b = mb == nullptr || mb[row] != 0;
    const long long base = row * k;
    for (int e = threadIdx.x; e < 2 * k; e += THREADS) {
      const bool a = e < k;
      const int j = a ? e : e - k;
      T x = a ? va[base + j] : vb[base + j];
      const int32_t o = a ? ia[base + j] : ib[base + j];
      if (!(a ? ok_a : ok_b)) x = Num<T>::neg_inf();
      const Key xk = Num<T>::key(x);
      const T* other = (a ? vb : va) + base;
      const bool ok = a ? ok_b : ok_a;
      int lo = 0;
      for (int stp = top; stp > 0; stp >>= 1) {
        const int p = lo + stp;
        if (p <= k) {
          const Key y = ok ? Num<T>::key(other[p - 1]) : kinf;
          if (y > xk || (!a && y == xk)) lo = p;
        }
      }
      const int pos = j + lo;
      if (pos < k) {
        vo[base + pos] = x;
        io[base + pos] = o;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Raise a kernel's dynamic shared memory limit to SMEM_MAX and prefer the
// largest shared-memory carveout, once per kernel and device (the
// attributes live in the context).
template <auto Kernel>
cudaError_t allow_smem() {
  static int done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done[dev] = 1;
  return err;
}

struct Args {
  const void *va, *ia, *vb, *ib, *ma, *mb;
  void *vo, *io;
  long long rows;
  int k;
};

template <typename T, int EPT>
cudaError_t run_bulk(const Plan& p, const Args& a, cudaStream_t st) {
  const cudaError_t err = allow_smem<merge_kernel<T, EPT>>();
  if (err != cudaSuccess) return err;
  merge_kernel<T, EPT><<<static_cast<unsigned>(p.grid), THREADS,
                         static_cast<size_t>(p.smem), st>>>(
      static_cast<const T*>(a.va), static_cast<const int32_t*>(a.ia),
      static_cast<const T*>(a.vb), static_cast<const int32_t*>(a.ib),
      static_cast<const uint8_t*>(a.ma), static_cast<const uint8_t*>(a.mb),
      static_cast<T*>(a.vo), static_cast<int32_t*>(a.io), a.rows, p.tiles);
  return cudaGetLastError();
}

template <typename T>
int launch_merge(const Args& a, long long route, long long rows_per_tile,
                 long long grid, void* stream) {
  if (a.rows <= 0) return 0;
  // the wrapper's plan must be this launcher's
  const void* bases[6] = {a.va, a.ia, a.vb, a.ib, a.vo, a.io};
  bool aligned = true;
  for (const void* b : bases)
    aligned = aligned && reinterpret_cast<uintptr_t>(b) % ALIGN == 0;
  Plan p;
  if (route < kBulk || route > kRow ||
      !make_plan(a.rows, a.k, static_cast<int>(sizeof(T)), aligned,
                 static_cast<int>(route), &p) ||
      p.rows_per_tile != rows_per_tile || p.grid != grid)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the bulk tile of BULK_K: THREADS * EPT == 2 * BULK_K * R
  constexpr int EPT = 2 * BULK_K * bulk_rows(sizeof(T)) / THREADS;
  cudaError_t err = cudaErrorInvalidValue;
  if (p.route == kBulk) {
    err = run_bulk<T, EPT>(p, a, st);
  } else if (p.route == kDirect && p.ept == 2) {
    const auto kern = a.k == 32 ? merge_kernel_warp<T, 32> : merge_kernel_warp<T, 0>;
    kern<<<static_cast<unsigned>(p.grid), THREADS, 0, st>>>(
        static_cast<const T*>(a.va), static_cast<const int32_t*>(a.ia),
        static_cast<const T*>(a.vb), static_cast<const int32_t*>(a.ib),
        static_cast<const uint8_t*>(a.ma), static_cast<const uint8_t*>(a.mb),
        static_cast<T*>(a.vo), static_cast<int32_t*>(a.io), a.rows, a.k);
    err = cudaGetLastError();
  } else if (p.route == kDirect) {
    merge_kernel_direct<T><<<static_cast<unsigned>(p.grid),
                             static_cast<unsigned>(p.threads),
                             static_cast<size_t>(p.smem), st>>>(
        static_cast<const T*>(a.va), static_cast<const int32_t*>(a.ia),
        static_cast<const T*>(a.vb), static_cast<const int32_t*>(a.ib),
        static_cast<const uint8_t*>(a.ma), static_cast<const uint8_t*>(a.mb),
        static_cast<T*>(a.vo), static_cast<int32_t*>(a.io), a.rows, a.k,
        static_cast<int>(p.rows_per_tile));
    err = cudaGetLastError();
  } else {
    merge_kernel_rows<T><<<static_cast<unsigned>(p.grid), THREADS, 0, st>>>(
        static_cast<const T*>(a.va), static_cast<const int32_t*>(a.ia),
        static_cast<const T*>(a.vb), static_cast<const int32_t*>(a.ib),
        static_cast<const uint8_t*>(a.ma), static_cast<const uint8_t*>(a.mb),
        static_cast<T*>(a.vo), static_cast<int32_t*>(a.io), a.rows, a.k);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// The merge plan as the launcher computes it: out[0..7] = route,
// rows_per_tile, ept, stages, threads, tiles, grid, smem
// (kernels/merge/merge.py::MergePlan); route 0 bulk, 1 direct, 2 row or
// -1 (the plan's choice).  0, or cudaErrorInvalidValue when the request
// cannot be planned.
extern "C" int repro_merge_plan(long long rows, long long k, int itemsize,
                                int aligned, int route, long long* out) {
  Plan p;
  if (!make_plan(rows, k, itemsize, aligned != 0, route, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long f[8] = {p.route,   p.rows_per_tile, p.ept,  p.stages,
                          p.threads, p.tiles,         p.grid, p.smem};
  for (int i = 0; i < 8; ++i) out[i] = f[i];
  return 0;
}

#define REPRO_MERGE_LAUNCHER(NAME, T)                                       \
  extern "C" int NAME(const void* va, const void* ia, const void* vb,       \
                      const void* ib, const void* ma, const void* mb,       \
                      void* vo, void* io, long long rows, int k,            \
                      long long route, long long rows_per_tile,             \
                      long long grid, void* stream) {                       \
    return launch_merge<T>(Args{va, ia, vb, ib, ma, mb, vo, io, rows, k},   \
                           route, rows_per_tile, grid, stream);             \
  }

REPRO_MERGE_LAUNCHER(repro_merge_f64, double)
REPRO_MERGE_LAUNCHER(repro_merge_f32, float)
REPRO_MERGE_LAUNCHER(repro_merge_bf16, __nv_bfloat16)
