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
// wait: one thread per output element (grid-stride), l fastest, so
// every load and store coalesces.  The churn variant writes s and send
// from one read of its inputs.
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
