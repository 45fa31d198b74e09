// Per-depth forward-sweep kernels for Hopper (sm_90a): level arrivals
// and the Appendix-A wait rule.
//
// arrivals replaces src/repro/kernels/sweep/sweep.py::arrivals_pallas
// (body _arrivals_kernel): out[e, l] = tq_prev[e, par_pos[l]] + dn[e, l].
// wait replaces src/repro/kernels/sweep/sweep.py::wait_pallas (bodies
// _wait_kernel and _wait_churn_kernel):
//   s = min(max(own, all_in), max(deadline, own)),
// under jnp.maximum / jnp.minimum's rule (a NaN operand gives the first
// NaN in that order, its bits kept; -0.0 < +0.0), and the churn variant
// also writes send = (death >= s) ? s : inf in the same pass.
//
// Bound: device-memory bytes.  Both do one add or four compares per
// element against 24 to 48 bytes moved per element in f64.
//
// arrivals: a 2-D grid, blocks over a row's columns times the rows
// (y, and z past 65,535 rows), so no thread divides to find its (e, l);
// 32-bit offsets where E * max(L, L_prev) + 2^17 < 2^31, else 64-bit.
// Two ways, the plan's choice per level:
//   gathering: one thread a column, ARR_THREADS a block; the lanes of a
//     warp take 32 consecutive columns, so dn, par_pos and out coalesce,
//     and each reads its parent from L2 (level order is not parent
//     order, so that read is irregular);
//   staging, for a large level whose parent row fits a block's shared
//     memory and is dense in children: SMS / E blocks a row copy the
//     row's parent level into shared memory, coalesced, STAGE_ELEMS
//     loads in flight a thread, then each thread takes slots of 16 bytes
//     of dn and out (2 f64, 4 f32, 8 bf16; the slots follow the 16-byte
//     boundaries of the flat array, so a row with an unaligned start
//     begins and ends with a partial slot, and a slot is one column
//     where dn or out is not 16-byte aligned), STAGE_ELEMS / VEC slots
//     at a time, their loads first, and gathers from shared memory.
// On the H100 (tools/arrivals_levels.py, PERF.md) staging wins at the
// two largest dense levels and loses at the small ones (latency-bound)
// and wherever parents are sparse; the gather with 16-byte slots loses
// to the gather by columns.  The wrapper (kernels/sweep/sweep.py::
// arrivals_plan) computes the plan; the launcher recomputes it
// (make_plan) and refuses any other.
//
// wait: flat over the E * L elements (the rule is elementwise).  Its
// bound is 4 arrays an element (3 in, 1 out), 6 for the churn variant
// (4 in, 2 out), over 3.35 TB/s.  The first design (one thread an
// element, scalar loads, 256-thread blocks over the whole level) held
// three things against it: (1) a thread kept one element of each operand
// in flight, about 12 KB an SM in bf16, 24 in f32, 48 in f64, so its
// share of the bound fell with the element size; (2) a bf16 warp load
// covered 64 bytes, two sectors; (3) each small level paid a launch of
// blocks over the whole level.  This design (kernels/sweep/sweep.py::
// wait_plan computes its plan, make_wait_plan recomputes it, the
// launcher refuses any other, repro_wait_plan exports it):
//   vector route, for a level of at least WAIT_VEC_MIN_BYTES an operand
//     whose operands and outputs all start on a 16-byte boundary, where
//     a thread's scalar loads (operands x itemsize) are fewer than
//     WAIT_SCALAR_LOAD_BYTES (the f64 churn variant's 32 bytes already
//     keep the scalar route level with the vector one, PERF.md): a
//     thread moves 16 bytes of each operand at a time (2 f64, 4 f32, 8
//     bf16), every load issued before any compare, through the read-only
//     path without L1 allocation; 16-byte stores with the default
//     write-back, so the parent level's gather of send finds it in L2.
//     Block 0 also takes the ragged tail (fewer than 16 bytes).  That is
//     16 bytes of each operand a thread in every dtype;
//   scalar route, for a smaller level (bound by its latency: one element
//     a thread is the shorter chain, and the first design's launch), the
//     f64 churn variant, or an operand or output off the 16-byte
//     boundary (a view one element into a larger tensor): the same walk,
//     one element a vector;
//   the rule as a few integer operations on total-order keys, each key
//     computed once (a vector of bf16 takes it eight times a thread);
//   grid: blocks of WAIT_THREADS over the whole level, one vector a
//     thread (a grid of one wave that strides measured slower at f64
//     level 4, whose last pass runs partly empty, and loading 2 or 4
//     vectors a thread slower at every level, PERF.md).
// Offsets are 64-bit (WaitOffset; tools/wait_levels.py measured 32-bit
// ones no faster over a sweep, PERF.md).  A level's launch floor stays (about 1.1 us
// of device time a launch, PERF.md): seven launches a sweep, four of
// them on small levels.
//
// Float grouping is exactly the plain version's, f64 adds as torch's
// FMA with alpha = 1 (the NaN it keeps), and bf16 adds in float and
// rounds once, as torch does, so every dtype is bit-equal to the plain
// version, NaNs included.
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
  // torch's add on the card is a + alpha * b as one FMA (alpha = 1):
  // the same value as a + b, and where both are NaN it keeps a's NaN,
  // as a plain double add does not
  __device__ static double add(double a, double b) {
    return __fma_rn(b, 1.0, a);
  }
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

// ---------------------------------------------------------------------------
// arrivals
// ---------------------------------------------------------------------------

constexpr int ARR_THREADS = 512;         // columns of a gathering block
constexpr int STAGE_THREADS = 1024;      // threads of a staging block
constexpr int STAGE_ELEMS = 8;           // loads in flight a staging thread
constexpr int SMS = 132;                 // the H100's SMs
constexpr int SMEM_MAX = 232448;         // a block's dynamic shared memory
constexpr int VEC_BYTES = 16;            // one vector access
constexpr int SECTOR = 32;               // bytes a gather moves from L2
constexpr long long STAGE_MIN_BYTES = 1LL << 21;  // dn of a staged level
constexpr int MAX_GRID_Y = 65535;
// threads, slots and rows past the ends count before their bounds tests
constexpr long long WIDE_MARGIN = 1LL << 17;

// The launch plan (kernels/sweep/sweep.py::ArrivalsPlan, same fields).
struct Plan {
  long long vec, staged, wide, threads, grid_x, grid_y, grid_z, slots, smem;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The plan of an (E, L) level of parent width Lp, or false when the
// request cannot be planned.  staged: 1 stage the parent level, 0
// gather it, -1 the plan's choice: stage a level whose dn holds at
// least STAGE_MIN_BYTES (a smaller launch is bound by its latency, and
// gathering is the shorter chain) where the parent row fits a block's
// shared memory and its copies (one a block of the row) move fewer
// bytes than the gathers' sectors, SECTOR bytes a column.  A gathering
// launch takes one column a thread (vec 1); a staged one a slot of vec
// columns, 16 bytes, where dn and out are 16-byte aligned.
bool make_plan(long long E, long long L, long long Lp, int itemsize,
               bool aligned, int staged, Plan* p) {
  if (E <= 0 || L <= 0 || Lp <= 0 || itemsize <= 0) return false;
  const long long vec = aligned ? VEC_BYTES / itemsize : 1;
  // slots of a row: its columns cut at the 16-byte boundaries of the
  // flat array; an unaligned row start adds one partial slot
  const long long row_slots =
      L % vec == 0 ? L / vec : (L + 2 * vec - 2) / vec;
  long long splits = E >= SMS ? 1 : SMS / E;
  if (splits > row_slots) splits = row_slots;
  const bool fits = Lp * itemsize <= SMEM_MAX;
  if (staged < 0)
    staged = fits && E * L * itemsize >= STAGE_MIN_BYTES &&
             splits * Lp * itemsize <= L * SECTOR;
  if (staged && !fits) return false;
  p->staged = staged;
  p->vec = staged ? vec : 1;
  p->wide = E * (L > Lp ? L : Lp) + WIDE_MARGIN >= (1LL << 31);
  p->threads = staged ? STAGE_THREADS : ARR_THREADS;
  p->slots = staged ? cdiv(row_slots, splits) : ARR_THREADS;
  p->grid_x = cdiv(staged ? row_slots : L, p->slots);
  // rows on y, and on z past MAX_GRID_Y
  p->grid_y = E < MAX_GRID_Y ? E : MAX_GRID_Y;
  p->grid_z = cdiv(E, p->grid_y);
  p->smem = staged ? Lp * itemsize : 0;
  return p->grid_z <= MAX_GRID_Y && p->grid_x < (1LL << 31);
}

template <typename O>
__device__ __forceinline__ O row_of_block() {
  return static_cast<O>(blockIdx.z) * gridDim.y + blockIdx.y;
}

// Gathering: block (tile x, row e), one thread a column, each parent
// read from L2.
template <typename T, typename I, typename O>
__global__ void __launch_bounds__(ARR_THREADS)
arrivals_kernel(const T* __restrict__ tq_prev, const T* __restrict__ dn,
                const I* __restrict__ par_pos, T* __restrict__ out, O E,
                O L, O Lp) {
  const O e = row_of_block<O>();
  const O l = static_cast<O>(blockIdx.x) * ARR_THREADS + threadIdx.x;
  if (e >= E || l >= L) return;
  const O i = e * L + l;
  out[i] = Num<T>::add(tq_prev[e * Lp + static_cast<O>(par_pos[l])], dn[i]);
}

// VEC elements moved as one 16-byte access (one element when VEC is 1)
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ src,
                                         T (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == sizeof(uint4)) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    __builtin_memcpy(v, &u, sizeof(u));
  } else {
    v[0] = src[0];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ dst,
                                          const T (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == sizeof(uint4)) {
    uint4 u;
    __builtin_memcpy(&u, v, sizeof(u));
    *reinterpret_cast<uint4*>(dst) = u;
  } else {
    dst[0] = v[0];
  }
}

// Staging: block (split x, row e) copies row e's parent level into
// shared memory, coalesced (STAGE_ELEMS loads in flight a thread), then
// covers slots [x * per, (x + 1) * per) of the row, U = STAGE_ELEMS / VEC
// slots a thread at a time: their par_pos and dn loads first, then the
// gathers from shared memory, the adds and the stores.
template <typename T, typename I, typename O, int VEC>
__global__ void __launch_bounds__(STAGE_THREADS)
arrivals_kernel_staged(const T* __restrict__ tq_prev,
                       const T* __restrict__ dn,
                       const I* __restrict__ par_pos, T* __restrict__ out,
                       O E, O L, O Lp, O per) {
  static_assert(STAGE_ELEMS % VEC == 0, "a thread's loads are whole slots");
  constexpr int U = STAGE_ELEMS / VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  T* parent = reinterpret_cast<T*>(smem);
  const O e = row_of_block<O>();
  if (e >= E) return;
  const T* trow = tq_prev + e * Lp;
  for (O i0 = threadIdx.x; i0 < Lp; i0 += STAGE_THREADS * STAGE_ELEMS) {
    T v[STAGE_ELEMS];
#pragma unroll
    for (int u = 0; u < STAGE_ELEMS; ++u) {
      const O i = i0 + u * STAGE_THREADS;
      if (i < Lp) v[u] = trow[i];
    }
#pragma unroll
    for (int u = 0; u < STAGE_ELEMS; ++u) {
      const O i = i0 + u * STAGE_THREADS;
      if (i < Lp) parent[i] = v[u];
    }
  }
  __syncthreads();
  const int s = static_cast<int>((e * L) & (VEC - 1));
  const T* drow = dn + e * L;
  T* orow = out + e * L;
  // this block's slots, cut at the row's own last slot
  const long long jcut = (static_cast<long long>(blockIdx.x) + 1) * per;
  const O row_end = (L + s + VEC - 1) / VEC;
  const O jend = jcut < row_end ? static_cast<O>(jcut) : row_end;
  for (O j0 = static_cast<O>(blockIdx.x) * per + threadIdx.x; j0 < jend;
       j0 += STAGE_THREADS * U) {
    T d[U][VEC];
    I k[U][VEC];
    bool full[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const O j = j0 + u * STAGE_THREADS;
      const O l0 = VEC * j - s;
      full[u] = VEC > 1 && j < jend && l0 >= 0 && l0 + VEC <= L;
      if (full[u]) {
        load_vec<T, VEC>(drow + l0, d[u]);
#pragma unroll
        for (int v = 0; v < VEC; ++v) k[u][v] = par_pos[l0 + v];
      } else if (j < jend) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const O l = l0 + v;
          if (l >= 0 && l < L) {
            d[u][v] = drow[l];
            k[u][v] = par_pos[l];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const O j = j0 + u * STAGE_THREADS;
      const O l0 = VEC * j - s;
      if (full[u]) {
        T r[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          r[v] = Num<T>::add(parent[k[u][v]], d[u][v]);
        store_vec<T, VEC>(orow + l0, r);
      } else if (j < jend) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const O l = l0 + v;
          if (l >= 0 && l < L) orow[l] = Num<T>::add(parent[k[u][v]], d[u][v]);
        }
      }
    }
  }
}

// Raise a kernel's dynamic shared memory limit to SMEM_MAX, once per
// kernel and device (the attribute lives in the context).
template <auto Kernel>
cudaError_t allow_smem() {
  static int done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err == cudaSuccess && dev < 64) done[dev] = 1;
  return err;
}

template <typename T, typename I, typename O, int VEC>
cudaError_t run_arrivals(const Plan& p, const T* tq_prev, const T* dn,
                         const I* par_pos, T* out, long long E, long long L,
                         long long Lp, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(p.grid_x),
                  static_cast<unsigned>(p.grid_y),
                  static_cast<unsigned>(p.grid_z));
  if (p.staged) {
    cudaError_t err = allow_smem<arrivals_kernel_staged<T, I, O, VEC>>();
    if (err != cudaSuccess) return err;
    arrivals_kernel_staged<T, I, O, VEC>
        <<<grid, STAGE_THREADS, static_cast<size_t>(p.smem), st>>>(
            tq_prev, dn, par_pos, out, static_cast<O>(E), static_cast<O>(L),
            static_cast<O>(Lp), static_cast<O>(p.slots));
  } else {
    arrivals_kernel<T, I, O><<<grid, ARR_THREADS, 0, st>>>(
        tq_prev, dn, par_pos, out, static_cast<O>(E), static_cast<O>(L),
        static_cast<O>(Lp));
  }
  return cudaGetLastError();
}

template <typename T, typename I>
int launch_arrivals(const void* tq_prev, const void* dn, const void* par_pos,
                    void* out, long long E, long long L, long long Lp,
                    long long vec, long long staged, long long wide,
                    void* stream) {
  if (E <= 0 || L <= 0) return 0;
  // the wrapper's plan must be this launcher's
  const bool aligned = reinterpret_cast<uintptr_t>(dn) % VEC_BYTES == 0 &&
                       reinterpret_cast<uintptr_t>(out) % VEC_BYTES == 0;
  Plan p;
  if ((staged != 0 && staged != 1) ||
      !make_plan(E, L, Lp, static_cast<int>(sizeof(T)), aligned,
                 static_cast<int>(staged), &p) ||
      p.vec != vec || p.wide != wide)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = VEC_BYTES / static_cast<int>(sizeof(T));
  const T* t = static_cast<const T*>(tq_prev);
  const T* d = static_cast<const T*>(dn);
  const I* pp = static_cast<const I*>(par_pos);
  T* o = static_cast<T*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.wide)
    err = p.vec == 1
              ? run_arrivals<T, I, long long, 1>(p, t, d, pp, o, E, L, Lp, st)
              : run_arrivals<T, I, long long, V>(p, t, d, pp, o, E, L, Lp, st);
  else
    err = p.vec == 1 ? run_arrivals<T, I, int, 1>(p, t, d, pp, o, E, L, Lp, st)
                     : run_arrivals<T, I, int, V>(p, t, d, pp, o, E, L, Lp, st);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// wait
// ---------------------------------------------------------------------------

constexpr int WAIT_THREADS = 256;        // threads of a wait block
// an operand's bytes from which the plan takes the vector route
constexpr long long WAIT_VEC_MIN_BYTES = 1LL << 20;
// a thread's scalar loads (operands x itemsize) from which the plan
// keeps the scalar route
constexpr int WAIT_SCALAR_LOAD_BYTES = 32;
// the wait's element and vector offsets
using WaitOffset = long long;

// The launch plan of the wait (kernels/sweep/sweep.py::WaitPlan, same
// fields).
struct WaitPlan {
  long long vec, threads, grid;
};

// The plan of `total` elements of `itemsize` bytes and `operands` inputs
// (3, or 4 for the churn variant), or false when the request cannot be
// planned.  vector: 1 the vector route (vec elements a 16-byte access;
// every operand and output 16-byte aligned), 0 the scalar route (one
// element), -1 the plan's choice: the vector route where it can be
// taken, an operand holds at least WAIT_VEC_MIN_BYTES (below that a
// launch is bound by its latency, and one element a thread is the
// shorter chain) and a thread's scalar loads are fewer than
// WAIT_SCALAR_LOAD_BYTES.  The grid covers the level, one vector a
// thread.
bool make_wait_plan(long long total, int itemsize, int operands,
                    bool aligned, int vector, WaitPlan* p) {
  if (total <= 0 || (itemsize != 2 && itemsize != 4 && itemsize != 8) ||
      (operands != 3 && operands != 4))
    return false;
  if (vector < 0)
    vector = aligned && total * itemsize >= WAIT_VEC_MIN_BYTES &&
             operands * itemsize < WAIT_SCALAR_LOAD_BYTES;
  else if (vector > 1 || (vector == 1 && !aligned))
    return false;
  const long long vec = vector ? VEC_BYTES / itemsize : 1;
  const long long blocks = cdiv(total / vec, WAIT_THREADS);
  p->vec = vec;
  p->threads = WAIT_THREADS;
  p->grid = blocks < 1 ? 1 : blocks;
  return p->grid < (1LL << 31);
}

// The total-order key of kernels/order.py (total_order_key): signed
// integers that order as the IEEE total order, -0.0 below +0.0; a bf16
// is keyed as the f32 of its bits (bits << 16), which orders the same.
__device__ __forceinline__ long long okey(double x) {
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7fffffffffffffffLL);
}
__device__ __forceinline__ int okey_bits(int b) {
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ int okey(float x) {
  return okey_bits(__float_as_int(x));
}
__device__ __forceinline__ int okey(__nv_bfloat16 x) {
  return okey_bits(static_cast<int>(
      static_cast<unsigned>(__bfloat16_as_ushort(x)) << 16));
}

__device__ __forceinline__ bool is_nan(double x) {
  return (__double_as_longlong(x) & 0x7fffffffffffffffLL) >
         0x7ff0000000000000LL;
}
__device__ __forceinline__ bool is_nan(float x) {
  return (__float_as_int(x) & 0x7fffffff) > 0x7f800000;
}
__device__ __forceinline__ bool is_nan(__nv_bfloat16 x) {
  return (__bfloat16_as_ushort(x) & 0x7fffu) > 0x7f80u;
}

// min(max(own, all_in), max(deadline, own)) under jnp.maximum /
// jnp.minimum's rule (the plain version's wait_ref): a NaN operand
// gives the first NaN of (own, all_in, deadline), its bits kept, which
// is what the rule gives composed; otherwise the total order decides,
// so -0.0 < +0.0.  Every result is one operand's bits.  Each key is
// computed once: the rule is a handful of integer operations an
// element, which a 16-byte vector of bf16 takes eight times.
template <typename T>
__device__ __forceinline__ T wait_rule(T own, T all_in, T deadline) {
  const auto ko = okey(own), ka = okey(all_in), kd = okey(deadline);
  const bool a_up = ko < ka, o_up = kd < ko;
  const T m1 = a_up ? all_in : own;      // max(own, all_in)
  const T m2 = o_up ? own : deadline;    // max(deadline, own)
  const auto k1 = a_up ? ka : ko, k2 = o_up ? ko : kd;
  T s = k2 < k1 ? m2 : m1;               // min(m1, m2)
  if (is_nan(deadline)) s = deadline;
  if (is_nan(all_in)) s = all_in;
  if (is_nan(own)) s = own;
  return s;
}

// dead at send time -> an arrival that can never release a parent
template <typename T>
__device__ __forceinline__ T churn_send(T death, T s) {
  return Num<T>::key(death) >= Num<T>::key(s) ? s : Num<T>::inf();
}

// 16 bytes through the read-only path, not allocated in L1 (each input
// is read once)
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ double ld_one(const double* p) { return __ldg(p); }
__device__ __forceinline__ float ld_one(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_one(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p)));
}

// VEC elements from one 16-byte read (one element when VEC is 1)
template <typename T, int VEC>
__device__ __forceinline__ void ld_wait(const T* p, T (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == sizeof(uint4)) {
    const uint4 u = ld_stream(p);
    __builtin_memcpy(v, &u, sizeof(u));
  } else {
    static_assert(VEC == 1, "a vector is 16 bytes or one element");
    v[0] = ld_one(p);
  }
}

// Block b's thread t takes vector j = b * WAIT_THREADS + t where
// j < units: all loads of the vector first, then the rule and 16-byte
// stores (the default write-back, so the parent level's gather finds
// them in L2).  Block 0 also takes the ragged tail, the fewer than VEC
// elements past the last whole vector.
template <typename T, int VEC, bool CHURN>
__device__ __forceinline__ void wait_body(
    const T* __restrict__ own, const T* __restrict__ all_in,
    const T* __restrict__ deadline, const T* __restrict__ death,
    T* __restrict__ s_out, T* __restrict__ send_out, WaitOffset total) {
  using O = WaitOffset;
  const O units = total / VEC;
  const O j = static_cast<O>(blockIdx.x) * WAIT_THREADS + threadIdx.x;
  if (j < units) {
    T o[VEC], a[VEC], d[VEC], x[VEC];
    ld_wait<T, VEC>(own + j * VEC, o);
    ld_wait<T, VEC>(all_in + j * VEC, a);
    ld_wait<T, VEC>(deadline + j * VEC, d);
    if constexpr (CHURN) ld_wait<T, VEC>(death + j * VEC, x);
    T s[VEC], snd[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      s[v] = wait_rule(o[v], a[v], d[v]);
      if constexpr (CHURN) snd[v] = churn_send(x[v], s[v]);
    }
    store_vec<T, VEC>(s_out + j * VEC, s);
    if constexpr (CHURN) store_vec<T, VEC>(send_out + j * VEC, snd);
  }
  if (VEC > 1 && blockIdx.x == 0) {
    const O i = units * VEC + static_cast<O>(threadIdx.x);
    if (i < total) {
      const T s = wait_rule(ld_one(own + i), ld_one(all_in + i),
                            ld_one(deadline + i));
      s_out[i] = s;
      if constexpr (CHURN) send_out[i] = churn_send(ld_one(death + i), s);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(WAIT_THREADS)
wait_kernel(const T* __restrict__ own, const T* __restrict__ all_in,
            const T* __restrict__ deadline, T* __restrict__ s_out,
            WaitOffset total) {
  wait_body<T, VEC, false>(own, all_in, deadline, nullptr, s_out, nullptr,
                           total);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(WAIT_THREADS)
wait_churn_kernel(const T* __restrict__ own, const T* __restrict__ all_in,
                  const T* __restrict__ deadline,
                  const T* __restrict__ death, T* __restrict__ s_out,
                  T* __restrict__ send_out, WaitOffset total) {
  wait_body<T, VEC, true>(own, all_in, deadline, death, s_out, send_out,
                          total);
}

// One launch: the churn variant where death is given.
template <typename T, int VEC>
cudaError_t run_wait(const WaitPlan& p, const T* own, const T* all_in,
                     const T* deadline, const T* death, T* s_out,
                     T* send_out, long long total, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(p.grid);
  if (death == nullptr)
    wait_kernel<T, VEC><<<grid, WAIT_THREADS, 0, st>>>(
        own, all_in, deadline, s_out, static_cast<WaitOffset>(total));
  else
    wait_churn_kernel<T, VEC><<<grid, WAIT_THREADS, 0, st>>>(
        own, all_in, deadline, death, s_out, send_out,
        static_cast<WaitOffset>(total));
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % VEC_BYTES == 0;
}

template <typename T>
int launch_wait(const void* own, const void* all_in, const void* deadline,
                const void* death, void* s_out, void* send_out,
                long long total, long long vec, long long grid,
                void* stream) {
  if (total <= 0) return 0;
  // the wrapper's plan must be this launcher's (its route taken as given)
  const bool aligned = aligned16(own) && aligned16(all_in) &&
                       aligned16(deadline) && aligned16(death) &&
                       aligned16(s_out) && aligned16(send_out);
  WaitPlan p;
  if (!make_wait_plan(total, static_cast<int>(sizeof(T)),
                      death == nullptr ? 3 : 4, aligned, vec > 1 ? 1 : 0,
                      &p) ||
      p.vec != vec || p.grid != grid)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = VEC_BYTES / static_cast<int>(sizeof(T));
  const T* o = static_cast<const T*>(own);
  const T* a = static_cast<const T*>(all_in);
  const T* d = static_cast<const T*>(deadline);
  const T* x = static_cast<const T*>(death);
  T* s = static_cast<T*>(s_out);
  T* n = static_cast<T*>(send_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      p.vec == 1 ? run_wait<T, 1>(p, o, a, d, x, s, n, total, st)
                 : run_wait<T, V>(p, o, a, d, x, s, n, total, st);
  return static_cast<int>(err);
}

}  // namespace

// The arrivals plan of an (E, L) level as the launcher computes it:
// out[0..8] = vec, staged, wide, threads, grid_x, grid_y, grid_z,
// slots, smem (kernels/sweep/sweep.py::ArrivalsPlan); staged 1, 0 or
// -1 (the plan's choice).  0, or cudaErrorInvalidValue when the request
// cannot be planned.
extern "C" int repro_arrivals_plan(long long E, long long L, long long Lp,
                                   int itemsize, int aligned, int staged,
                                   long long* out) {
  Plan p;
  if (!make_plan(E, L, Lp, itemsize, aligned != 0, staged, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long f[9] = {p.vec,    p.staged, p.wide,  p.threads, p.grid_x,
                          p.grid_y, p.grid_z, p.slots, p.smem};
  for (int i = 0; i < 9; ++i) out[i] = f[i];
  return 0;
}

#define REPRO_ARRIVALS_LAUNCHER(NAME, T, I)                                 \
  extern "C" int NAME(const void* tq_prev, const void* dn,                  \
                      const void* par_pos, void* out, long long E,          \
                      long long L, long long Lp, long long vec,             \
                      long long staged, long long wide, void* stream) {     \
    return launch_arrivals<T, I>(tq_prev, dn, par_pos, out, E, L, Lp, vec,  \
                                 staged, wide, stream);                     \
  }

// The wait plan of `total` elements and `operands` inputs (3, or 4 for
// the churn variant) as the launcher computes it: out[0..2] = vec,
// threads, grid (kernels/sweep/sweep.py::WaitPlan); vector 1, 0 or -1
// (the plan's choice).  0, or cudaErrorInvalidValue when the request
// cannot be planned.
extern "C" int repro_wait_plan(long long total, int itemsize, int operands,
                               int aligned, int vector, long long* out) {
  WaitPlan p;
  if (!make_wait_plan(total, itemsize, operands, aligned != 0, vector, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long f[3] = {p.vec, p.threads, p.grid};
  for (int i = 0; i < 3; ++i) out[i] = f[i];
  return 0;
}

#define REPRO_WAIT_LAUNCHERS(SUFFIX, T)                                     \
  extern "C" int repro_wait_##SUFFIX(                                       \
      const void* own, const void* all_in, const void* deadline,            \
      void* s_out, long long total, long long vec, long long grid,          \
      void* stream) {                                                       \
    return launch_wait<T>(own, all_in, deadline, nullptr, s_out, nullptr,   \
                          total, vec, grid, stream);                        \
  }                                                                         \
  extern "C" int repro_wait_churn_##SUFFIX(                                 \
      const void* own, const void* all_in, const void* deadline,            \
      const void* death, void* s_out, void* send_out, long long total,      \
      long long vec, long long grid, void* stream) {                        \
    return launch_wait<T>(own, all_in, deadline, death, s_out, send_out,    \
                          total, vec, grid, stream);                        \
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
