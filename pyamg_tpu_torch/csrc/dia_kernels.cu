// Banded (DIA) kernels of the solve phase, hand-written for Hopper (sm_90a).
//
// K1 dia_spmv: y[i] = sum_d data[d, i] * x[i + off_d], x read as 0 outside
//   [0, n).  Replaces pyamg_tpu/ops/pallas_kernels.py:_dia_call (the fused
//   TPU banded SpMV behind dia_spmv_pallas).
// K2 dia_gs_sweep: a sequence of multicolor Gauss-Seidel passes on a DIA
//   operator, all in one launch: in pass p every row i with
//   colors[i] == order[p] gets x_i += (omega * Dinv_i) * (b_i - (A x)_i)
//   from the x left by pass p - 1.  Replaces
//   pyamg_tpu/ops/pallas_kernels.py:_dia_gs_call, which ran every pass in
//   one TPU grid (passes x tiles) with x resident in VMEM.
//
// Both are bound by device-memory bytes: K1 reads ndiag*n matrix values
// plus x and writes y, 2 flops per 4-8 bytes.
//
// K1.  A thread owns kR consecutive rows, kR = 16 / sizeof(T) (4 float, 2
// double), so a warp's rows of one diagonal are 16-byte loads of the band:
// data's rows lie npad apart and npad is a multiple of 8192 (any npad that
// is a multiple of kR will do; another npad, or a band not on a 16-byte
// boundary, takes scalar loads in the same kernel).  x is read value by
// value, masked to [0, n): a warp's reads of one diagonal cover 512
// contiguous bytes, which L1 serves.  Reading x as two aligned 16-byte
// vectors a diagonal and picking the rows' values from off mod kR, the
// counterpart of the TPU kernel's lane rolls, measured slower on every
// main-path operator (PERF.md, section 6).  The coefficients and x values
// of a group of diagonals are all loaded before any is used (band_rows,
// shared with K2), so a thread has its whole band in flight at once
// instead of a load pair a diagonal; the 5-, 7- and 9-diagonal operators
// of the main paths get kernels of their own width (every diagonal in one
// group, offsets at fixed places of the parameter), any other width takes
// groups of 8 (slower at all three widths, and at 9 by a second round
// trip: same section).  An (n, k) x is one launch: thread t takes row
// group t / k of column t % k, so the k threads of a row group read the
// same band vector and the band is read once for all columns.  The
// offsets travel by value in a __grid_constant__ kernel parameter (the
// constant bank): no load from device memory and no shared-memory
// staging.  A band of more than kSpmvOffsets diagonals reads them from
// device memory instead, a load that the band's addresses wait for.
// ops/dia_kernels.spmv_geometry gives the launch shape: enough blocks to
// spread small operators over every SM.
//
// K2.  A sweep of P passes used to be P launches, each reading the whole
// band again; one pass of a 250,000-row operator is a few microseconds of
// bytes and about as much launch gap.  Now one launch runs every pass.
// Rows are cut into contiguous ranges of `rows`, one per block, and the
// launch is cooperative, so every block is resident or the launch fails.
// A pass reads x up to h = max |offset| rows beyond a block's range, so
// before pass p a block needs only its neighbours' rows within h of its
// own, as pass p - 1 left them.  Two regimes, chosen in
// ops/dia_kernels.py (gs_geometry):
//   (a) staged: a block copies its rows of the band, b, Dinv (as
//       omega * Dinv) and colors, and its rows of x0, into shared memory
//       once (cp.async), so the band is read from device memory once per
//       sweep.  x lives in two shared buffers of [h | rows | h]: before
//       each pass the block fills the h rows on each side from its
//       neighbours, then every row reads shared memory only.  The rows
//       within h of a block's edges are the only ones another block
//       reads; each pass does them first and publishes them as tagged
//       words, the value and the pass in one 64-bit store (two for
//       float64), then does the interior while they travel.  A reader
//       polls the words it needs until their tag is the pass it waits
//       for: the data carries its own flag, so no fence and no separate
//       counter sit between two passes.  Tags are epoch + pass, and
//       every launch raises the epoch past every tag it wrote (see
//       below), so the words never need clearing.
//   (b) device: the band does not fit in the resident blocks' shared
//       memory, or reaches past the next block (then every row of a
//       staged block would be exchanged each pass, which measured slower
//       than reading the band again from L2); each pass reads the band
//       (and b, Dinv, colors, x) from device memory and writes every row
//       of x, still in one launch.  After its pass a block publishes
//       flags[block] = epoch + p + 1 with a release store, and the blocks
//       within `reach` = ceil(h / rows) of it spin on it with acquire
//       loads before pass p + 1.  A launch of one pass waits for no
//       block; it is an ordinary launch of any number of blocks.
// In both, x in device memory is double-buffered: pass p reads what pass
// p - 1 wrote and writes the other buffer.  The wait relation is
// symmetric: a block waits for every block whose rows it reads and for
// every block that reads its rows (in (a) it also polls the rows that the
// negated offsets reach; in (b) it waits for all blocks within `reach`).
// So a block runs at most one pass ahead of any block that reads its
// rows, a buffer is never overwritten while still read (with a one-sided
// band, a block that waited only for the rows it reads could run two
// passes ahead of its reader and overwrite the words the reader still
// polls), and every read sees exactly the previous pass's x,
// as the plain version computes it (no reliance on the coloring: an
// explicit zero in the band times an inf or NaN of the same color gives
// NaN where the plain version does).  Halo x is read through L2
// (ld.relaxed.gpu, ld.global.cg), never through L1, which is not
// coherent across SMs.  Pass 0 reads x0 itself; the last pass writes out.
//
// The 5-diagonal operators of the 2-D Poisson path get a staged kernel of
// their own width, with the offsets in registers and all terms of a row
// loaded together; probes/k2_regimes.py times it against the kernel for
// any width (PERF.md, section 6).  Tried on the card and
// dropped (same section): pass counters instead of tagged words in the
// staged regime (slower at all three main-path operators), sorting a block's
// rows by color so that a pass runs whole warps of its color (the sort and
// the indirection cost more than the idle lanes), and two rows a thread
// computed without a branch.
//
// The epoch lives in device memory, ctl[0], beside a count of the
// launch's finished blocks, ctl[1]: every block reads the epoch as it
// starts, and the last block to finish (the count reaching gridDim.x,
// after every block read it) raises it by n_order + 1 and clears the
// count.  So a launch recorded in a CUDA graph takes a new epoch on every
// replay: with the epoch baked into the launch, a replay would poll for
// the tags of the replay before it, find that replay's words still
// carrying them and read them before their writer wrote, and would find
// the pass counters already at the values it waits for.  Eager launches
// and replays that share an exchange take turns on one ctl.  The host
// counts the same epochs and starts counters, words and epoch afresh well
// before the epoch could pass 2**32 (ops/dia_kernels._Exchange).
//
// Arithmetic equals the plain versions' bit for bit: each product is
// rounded (mul_rn), the terms are added in diagonal order starting from
// the first term (add_rn), and the update is x + (omega * Dinv) * (b - acc)
// in that association; no contraction into FMA.  Every in-range slot is
// multiplied, so an inf or NaN in x gives NaN where the plain version
// does.
//
// C ABI (loaded with ctypes): every entry point checks its arguments and
// launch shape, launches on the given stream, does not synchronise,
// allocates nothing, and returns a CUDA error code (0 on success).
// K2's offsets and pass order are int32 arrays in device memory, and K1
// takes its offsets from the host (by value) or, past kSpmvOffsets
// diagonals, from device memory, so an operator may have any number of
// diagonals.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kSpmvThreads = 256;       // K1 block, at most
// K1 offsets passed by value, at most (PERF.md, section 6: the measured
// cost of a larger parameter)
#ifndef PYAMG_DIA_SPMV_OFFSETS
#define PYAMG_DIA_SPMV_OFFSETS 1024
#endif
constexpr int kSpmvOffsets = PYAMG_DIA_SPMV_OFFSETS;
constexpr int kMaxThreads = 1024;       // K2 block, at most
constexpr int kMaxSmem = 232448;        // dynamic shared memory a block may use
constexpr int kMaxFlagBlocks = 1024;    // entries of the pass-counter array
// polls of a neighbour's pass counter or tagged word (seconds of L2 round
// trips; a pass takes microseconds) after which a block gives up with a
// trap
constexpr unsigned kMaxSpins = 1u << 24;

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
};

__device__ __forceinline__ bool in_range(int j, int lo, int cnt) {
  return static_cast<unsigned>(j - lo) < static_cast<unsigned>(cnt);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// an asynchronous copy of one 4- or 8-byte element into shared memory
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte elements");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// the end of a K2 launch: the last block to finish raises the epoch past
// every tag and counter value the launch wrote and clears the count of
// finished blocks (see the note at the top)
__device__ __forceinline__ void finish_launch(unsigned* ctl, unsigned epoch,
                                              int n_order) {
  __syncthreads();              // every thread of the block has finished
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctl + 1, 1u) == gridDim.x - 1) {
      ctl[1] = 0u;
      ctl[0] = epoch + static_cast<unsigned>(n_order) + 1u;
    }
  }
}

// a value as kWords 64-bit words, each a 32-bit piece of it below a 32-bit
// tag: a word is stored and loaded whole, so a reader that sees the tag it
// waits for sees that pass's piece beside it
template <typename T>
struct Tagged;

template <>
struct Tagged<float> {
  static constexpr int kWords = 1;
  static __device__ __forceinline__ void pack(float v, unsigned tag,
                                              unsigned long long (&w)[1]) {
    w[0] = static_cast<unsigned long long>(tag) << 32 | __float_as_uint(v);
  }
  static __device__ __forceinline__ float unpack(
      const unsigned long long (&w)[1]) {
    return __uint_as_float(static_cast<unsigned>(w[0]));
  }
};

template <>
struct Tagged<double> {
  static constexpr int kWords = 2;
  static __device__ __forceinline__ void pack(double v, unsigned tag,
                                              unsigned long long (&w)[2]) {
    const unsigned long long bits = __double_as_longlong(v);
    const unsigned long long t = static_cast<unsigned long long>(tag) << 32;
    w[0] = t | (bits & 0xffffffffull);
    w[1] = t | (bits >> 32);
  }
  static __device__ __forceinline__ double unpack(
      const unsigned long long (&w)[2]) {
    return __longlong_as_double((w[1] << 32) | (w[0] & 0xffffffffull));
  }
};

// ---------------------------------------------------------------------------
// band_rows: shared by K1 and K2
// ---------------------------------------------------------------------------

// acc[r] = sum_d a_d[r] * x_d[r] for kR rows, each product rounded and the
// terms added in diagonal order from the first.  load(d, a, x) fills the
// kR coefficients and x values of diagonal d; the loads of kChunk
// diagonals are issued before any is used, so that they are in flight
// together.
template <typename T, int kR, int kChunk, typename Load>
__device__ __forceinline__ void band_rows(int ndiag, Load load,
                                          T (&acc)[kR]) {
  for (int d0 = 0; d0 < ndiag; d0 += kChunk) {
    T a[kChunk][kR], xv[kChunk][kR];
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (d0 + u < ndiag) load(d0 + u, a[u], xv[u]);
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (d0 + u < ndiag) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const T t = Rn<T>::mul(a[u][r], xv[u][r]);
          acc[r] = d0 + u == 0 ? t : Rn<T>::add(acc[r], t);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

// 16 bytes of T: kN values, loaded and stored whole
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<double> {
  static constexpr int kN = 2;
  static __device__ __forceinline__ void load(const double* p,
                                              double (&v)[2]) {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  }
  static __device__ __forceinline__ void store(double* p,
                                               const double (&v)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

// which operands of a K1 launch take 16-byte accesses
constexpr int kBandVec = 1;   // the band: npad % kR == 0, data aligned
constexpr int kYVec = 2;      // y: k == 1, aligned

// K1's offsets by value, up to kCap of them
template <int kCap>
struct SpmvBand {
  int ndiag;
  int off[kCap];
};

// kD > 0: exactly kD diagonals, all loaded in one group; kD == 0: any
// number, in groups of 8.  kByValue: the offsets are band.off, else
// `offsets` in device memory.
template <typename T, int kD, bool kByValue, typename Band>
__global__ void __launch_bounds__(kSpmvThreads)
dia_spmv_kernel(const T* __restrict__ data, long long npad,
                const __grid_constant__ Band band,
                const int* __restrict__ offsets, int n, int k,
                const T* __restrict__ x, T* __restrict__ y, int vec) {
  constexpr int kR = Vec16<T>::kN;
  constexpr int kChunk = kD > 0 ? kD : 8;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = k == 1 ? t : t / k;
  const int c = t - g * k;
  const int i0 = g * kR;
  if (i0 >= n) return;
  const int nd = kD > 0 ? kD : band.ndiag;
  auto off = [&](int d) {
    if constexpr (kByValue) {
      return band.off[d];
    } else {
      return __ldg(offsets + d);
    }
  };
  const bool bvec = vec & kBandVec;
  T acc[kR];
  band_rows<T, kR, kChunk>(nd, [&](int d, T (&a)[kR], T (&xv)[kR]) {
    const int o = off(d);
    const T* p = data + d * npad + i0;
    if (bvec) {
      Vec16<T>::load(p, a);
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r) a[r] = i0 + r < n ? __ldg(p + r) : T(0);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int j = i0 + r + o;
      xv[r] = in_range(j, 0, n) ? __ldg(x + static_cast<long long>(j) * k + c)
                                : T(0);
    }
  }, acc);
  if ((vec & kYVec) && i0 + kR <= n) {
    Vec16<T>::store(y + i0, acc);
  } else {
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (i0 + r < n) y[static_cast<long long>(i0 + r) * k + c] = acc[r];
  }
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// the shared-memory bytes of a block: when staged, for its `rows` rows
// the band, b, omega * Dinv (T each) and colors (int), two buffers of x
// of rows + 2 * halo (T) and a byte for each halo row; then the offsets
// (int)
__host__ __device__ inline long long gs_smem(bool staged, int rows,
                                             int ndiag, int halo, int item) {
  return (staged ? static_cast<long long>(rows) * ((ndiag + 2LL) * item + 4) +
                       2LL * (rows + 2LL * halo) * item + 2LL * halo
                 : 0) + 4LL * ndiag;
}

// rows are visited boundary first: [0, nl) and [rs, cnt) of a block's
// cnt rows, the rows within `halo` of its edges, which other blocks read,
// then the interior [nl, rs), which only the block reads
struct Visit {
  int nl, rs, nbound;
  __device__ Visit(int cnt, int halo)
      : nl(min(halo, cnt)), rs(max(nl, cnt - halo)), nbound(nl + cnt - rs) {}
  __device__ int row(int k) const {
    return k < nl ? k : k < nbound ? rs + (k - nl) : nl + (k - nbound);
  }
};

// the update of one row: x + (omega * Dinv) * (b - acc), as the plain
// version associates it
template <typename T>
__device__ __forceinline__ T gs_update(T x, T od, T b, T acc) {
  return Rn<T>::add(x, Rn<T>::mul(od, Rn<T>::sub(b, acc)));
}

// regime (a): see the note at the top.  kD > 0: the operator has exactly
// kD diagonals, whose offsets the threads keep in registers and whose
// terms they load together; kD == 0: any number, one term after another
template <typename T, int kD>
__global__ void __launch_bounds__(kMaxThreads, 1)
dia_gs_staged_kernel(const T* __restrict__ data, long long npad, int ndiag,
                     const int* __restrict__ offsets, int n,
                     const T* __restrict__ b, const T* __restrict__ dinv,
                     const int* __restrict__ colors,
                     const int* __restrict__ order, int n_order, T omega,
                     const T* __restrict__ x0, T* __restrict__ out,
                     unsigned long long* words, unsigned* ctl, int rows,
                     int halo) {
  constexpr int kW = Tagged<T>::kWords;
  const unsigned epoch = __ldcg(ctl);
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.x * rows;
  const int cnt = min(rows, n - r0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int last = n_order - 1;
  const int xw = rows + 2 * halo;
  // [ndiag][rows] band, [rows] b, [rows] omega * Dinv, two buffers of x,
  // each [halo | rows | halo] (the block's rows with the rows within
  // `halo` on each side; 0 outside [0, n)), [rows] colors, [ndiag]
  // offsets, [2 * halo] whether a halo row is read
  T* band = reinterpret_cast<T*>(smem);
  T* sb = band + static_cast<long long>(ndiag) * rows;
  T* sod = sb + rows;
  T* xs = sod + rows;
  T* xn = xs + xw;
  int* scol = reinterpret_cast<int*>(xn + xw);
  int* soffs = scol + rows;
  unsigned char* need = reinterpret_cast<unsigned char*>(soffs + ndiag);
  const Visit vis(cnt, halo);
  // the tagged words of row i in buffer q (the values after pass q - 1
  // live in buffer q & 1, tagged epoch + q)
  auto word = [&](int q, int i) {
    return words + (static_cast<long long>(q & 1) * n + i) * kW;
  };
  int c_next = __ldg(order);
  for (int d = 0; d < ndiag; ++d)
    for (int li = tid; li < cnt; li += nt)
      cp_async(band + d * rows + li, data + d * npad + r0 + li);
  for (int li = tid; li < cnt; li += nt) {
    cp_async(sb + li, b + r0 + li);
    cp_async(sod + li, dinv + r0 + li);
    cp_async(xs + halo + li, x0 + r0 + li);
    cp_async(scol + li, colors + r0 + li);
  }
  for (int d = tid; d < ndiag; d += nt) soffs[d] = offsets[d];
  // halo rows outside [0, n) read 0, in both buffers
  for (int k = tid; k < 2 * halo; k += nt) {
    const int j = k < halo ? k - halo : cnt + (k - halo);
    need[k] = 0;
    if (!in_range(r0 + j, 0, n)) {
      xs[halo + j] = T(0);
      xn[halo + j] = T(0);
    }
  }
  cp_async_wait_all();
  // each thread scales the rows it copied
  for (int li = tid; li < cnt; li += nt) sod[li] = Rn<T>::mul(omega, sod[li]);
  __syncthreads();
  // a halo row is read if some diagonal reaches it from the block's rows:
  // diagonal d reads [off, off + cnt) of the block's numbering.  The rows
  // that -off reaches are read too, so that a block waits for every block
  // that reads its rows (see the note at the top)
  for (int d = 0; d < 2 * ndiag; ++d) {
    const int off = d < ndiag ? soffs[d] : -soffs[d - ndiag];
    const int lo = off, hi = off + cnt;
    for (int j = max(lo, -halo) + tid; j < min(hi, 0); j += nt)
      if (in_range(r0 + j, 0, n)) need[j + halo] = 1;
    for (int j = max(lo, cnt) + tid; j < min(hi, cnt + halo); j += nt)
      if (in_range(r0 + j, 0, n)) need[j - cnt + halo] = 1;
  }
  __syncthreads();
  int off[kD > 0 ? kD : 1];
#pragma unroll
  for (int d = 0; d < kD; ++d) off[d] = soffs[d];

  for (int p = 0; p < n_order; ++p) {
    const int c = c_next;
    if (p < last) c_next = __ldg(order + p + 1);   // read ahead of its pass

    // the other blocks' rows this block reads, as pass p - 1 left them:
    // x0 itself, or the tagged words of pass p - 1, polled until their tag
    // is epoch + p; kChunk rows' loads in flight a thread
    constexpr int kChunk = 8 / kW;
    const unsigned tag = epoch + static_cast<unsigned>(p);
    for (int k0 = tid; k0 < 2 * halo; k0 += kChunk * nt) {
      unsigned long long w[kChunk][kW];
      T v[kChunk];
      int j[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int k = k0 + u * nt;
        j[u] = k < halo ? k - halo : cnt + (k - halo);
        if (k >= 2 * halo || !need[k]) {
          j[u] = -halo - 1;                         // no row to read
        } else if (p == 0) {
          v[u] = __ldcg(x0 + r0 + j[u]);
        } else {
#pragma unroll
          for (int q = 0; q < kW; ++q)
            w[u][q] = ld_relaxed(word(p, r0 + j[u]) + q);
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (j[u] < -halo) continue;
        if (p > 0) {
          for (unsigned spins = 0;; ++spins) {
            bool ready = true;
#pragma unroll
            for (int q = 0; q < kW; ++q)
              ready &= static_cast<unsigned>(w[u][q] >> 32) == tag;
            if (ready) break;
            if (spins == kMaxSpins) __trap();   // fail rather than hang
#pragma unroll
            for (int q = 0; q < kW; ++q)
              w[u][q] = ld_relaxed(word(p, r0 + j[u]) + q);
          }
          v[u] = Tagged<T>::unpack(w[u]);
        }
        xs[halo + j[u]] = v[u];
      }
    }
    __syncthreads();

    // the rows k in [k0, k1) of the visiting order: written to xn (the
    // boundary rows also as tagged words), or, in the last pass, to out
    auto sweep = [&](int k0, int k1) {
      for (int k = k0 + tid; k < k1; k += nt) {
        const int li = vis.row(k);
        const int i = r0 + li;
        T v = xs[halo + li];
        if (scol[li] == c) {
          const T* xr = xs + halo + li;
          T acc;
          if constexpr (kD > 0) {
            T a[kD], xv[kD];
#pragma unroll
            for (int d = 0; d < kD; ++d) {
              a[d] = band[d * rows + li];
              xv[d] = xr[off[d]];
            }
            acc = Rn<T>::mul(a[0], xv[0]);
#pragma unroll
            for (int d = 1; d < kD; ++d)
              acc = Rn<T>::add(acc, Rn<T>::mul(a[d], xv[d]));
          } else {
            acc = Rn<T>::mul(band[li], xr[soffs[0]]);
#pragma unroll 4
            for (int d = 1; d < ndiag; ++d)
              acc = Rn<T>::add(acc,
                               Rn<T>::mul(band[d * rows + li], xr[soffs[d]]));
          }
          v = gs_update(v, sod[li], sb[li], acc);
        }
        if (p == last) {
          out[i] = v;
        } else {
          xn[halo + li] = v;
          if (k < vis.nbound) {
            unsigned long long w[kW];
            Tagged<T>::pack(v, tag + 1u, w);
#pragma unroll
            for (int q = 0; q < kW; ++q) st_relaxed(word(p + 1, i) + q, w[q]);
          }
        }
      }
    };
    // the boundary first, so that its words travel during the interior
    sweep(0, vis.nbound);
    sweep(vis.nbound, cnt);
    __syncthreads();              // the block's rows of pass p are written
    T* t = xs;
    xs = xn;
    xn = t;
  }
  finish_launch(ctl, epoch, n_order);
}

// regime (b): see the note at the top
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
dia_gs_device_kernel(const T* __restrict__ data, long long npad, int ndiag,
                     const int* __restrict__ offsets, int n,
                     const T* __restrict__ b, const T* __restrict__ dinv,
                     const int* __restrict__ colors,
                     const int* __restrict__ order, int n_order, T omega,
                     const T* x0, T* out, T* scratch, unsigned* flags,
                     unsigned* ctl, int rows, int reach, int halo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blk = blockIdx.x;
  const int r0 = blk * rows;
  const int cnt = min(rows, n - r0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int last = n_order - 1;
  int* soffs = reinterpret_cast<int*>(smem);          // [ndiag] offsets
  const Visit vis(cnt, halo);
  const unsigned epoch = __ldcg(ctl);

  int c_next = __ldg(order);
  for (int d = tid; d < ndiag; d += nt) soffs[d] = offsets[d];
  __syncthreads();
  for (int p = 0; p < n_order; ++p) {
    // pass q writes `out` when last - q is even, so the last pass does
    const T* src = p == 0 ? x0 : ((last - p + 1) & 1 ? scratch : out);
    T* dst = (last - p) & 1 ? scratch : out;
    const int c = c_next;
    if (p < last) c_next = __ldg(order + p + 1);   // read ahead of its pass
    for (int k = tid; k < cnt; k += nt) {
      const int i = r0 + vis.row(k);
      T v = __ldcg(src + i);
      if (__ldg(colors + i) == c) {
        T acc[1];
        band_rows<T, 1, 8>(ndiag, [&](int d, T (&a)[1], T (&xv)[1]) {
          a[0] = __ldg(data + d * npad + i);
          const int j = i + soffs[d];
          xv[0] = in_range(j, 0, n) ? __ldcg(src + j) : T(0);
        }, acc);
        v = gs_update(v, Rn<T>::mul(omega, __ldg(dinv + i)), __ldg(b + i),
                      acc[0]);
      }
      dst[i] = v;
    }
    if (p == last) break;
    // publish pass p, then wait for the neighbours' pass p
    const unsigned done = epoch + static_cast<unsigned>(p) + 1u;
    __syncthreads();              // the block's rows of pass p are written
    if (tid == 0) st_release(flags + blk, done);
    const int lo = max(0, blk - reach);
    const int hi = min(static_cast<int>(gridDim.x) - 1, blk + reach);
    for (int k = lo + tid; k <= hi; k += nt) {
      if (k == blk) continue;
      for (unsigned spins = 0;
           static_cast<int>(ld_acquire(flags + k) - done) < 0; ++spins)
        if (spins == kMaxSpins) __trap();   // fail rather than hang
    }
    __syncthreads();              // the neighbours' pass p is visible
  }
  finish_launch(ctl, epoch, n_order);
}

// how many blocks of `kernel` fit on the card at once, with `threads`
// threads and `smem` bytes of dynamic shared memory each; the answer is
// remembered for the few shapes a program launches
cudaError_t resident_blocks(const void* kernel, int threads, int smem,
                            long long* blocks) {
  struct Entry {
    const void* kernel;
    int threads, smem, dev;
    long long blocks;
  };
  static Entry seen[32];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int k = 0; k < used; ++k)
    if (seen[k].kernel == kernel && seen[k].threads == threads &&
        seen[k].smem == smem && seen[k].dev == dev) {
      *blocks = seen[k].blocks;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return e;
  *blocks = static_cast<long long>(per_sm) * sms;
  seen[used % 32] = {kernel, threads, smem, dev, *blocks};
  ++used;
  return cudaSuccess;
}

// launch `kernel`; `cooperative` (its blocks wait for each other): after
// checking that every block can be resident at once (or the waits would
// deadlock)
template <typename Kernel, typename... Args>
int launch(Kernel kernel, bool cooperative, int* allowed, int blocks,
           int threads, int smem, void* stream, Args... args) {
  cudaError_t e = cudaSuccess;
  if (smem > *allowed) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    *allowed = smem;
  }
  if (cooperative) {
    long long resident = 0;
    e = resident_blocks(reinterpret_cast<const void*>(kernel), threads, smem,
                        &resident);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (resident < blocks)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cooperative ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// K1 over `threads` x `blocks` threads (ops/dia_kernels.spmv_geometry):
// the offsets by value from `host_offsets` when there are at most
// kSpmvOffsets, else from `offsets` in device memory
template <typename T, int kD, bool kByValue, typename Band>
int spmv_launch(const Band& band, int blocks, int threads, void* stream,
                const T* data, long long npad, const int* offsets, int n,
                int k, const T* x, T* y, int vec) {
  dia_spmv_kernel<T, kD, kByValue, Band>
      <<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          data, npad, band, offsets, n, k, x, y, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dia_spmv(const T* data, int ndiag, long long npad,
             const int* host_offsets, const int* offsets, int n, int k,
             const T* x, T* y, int threads, int blocks, void* stream) {
  constexpr int kR = Vec16<T>::kN;
  if (n <= 0) return 0;
  const long long work = (n + kR - 1LL) / kR * k;
  const bool bad = ndiag < 1 || npad < n || k < 1 ||
                   host_offsets == nullptr || threads < 32 ||
                   threads > kSpmvThreads || threads % 32 != 0 ||
                   blocks < 1 ||
                   static_cast<long long>(blocks) * threads < work ||
                   static_cast<long long>(blocks - 1) * threads >= work ||
                   static_cast<long long>(blocks) * threads > INT_MAX ||
                   (ndiag > kSpmvOffsets && offsets == nullptr);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const int vec = (npad % kR == 0 && aligned(data) ? kBandVec : 0) |
                  (k == 1 && aligned(y) ? kYVec : 0);
  if (ndiag > kSpmvOffsets) {
    const SpmvBand<1> band = {ndiag, {0}};
    return spmv_launch<T, 0, false>(band, blocks, threads, stream, data,
                                    npad, offsets, n, k, x, y, vec);
  }
  SpmvBand<kSpmvOffsets> band;    // the offsets past ndiag are not read
  band.ndiag = ndiag;
  std::memcpy(band.off, host_offsets, sizeof(int) * ndiag);
  auto run = [&](auto width) {
    return spmv_launch<T, decltype(width)::value, true>(
        band, blocks, threads, stream, data, npad, nullptr, n, k, x, y, vec);
  };
#ifndef PYAMG_DIA_SPMV_GENERIC   // a build for a timing probe: any width
  // the main paths' 2-D 5-point, 3-D 7-point and 2-D 9-point operators
  if (ndiag == 5) return run(std::integral_constant<int, 5>());
  if (ndiag == 7) return run(std::integral_constant<int, 7>());
  if (ndiag == 9) return run(std::integral_constant<int, 9>());
#endif
  return run(std::integral_constant<int, 0>());
}

// staged: `words` holds 2 * n * Tagged<T>::kWords words; device regime:
// `scratch` holds n values and `flags` kMaxFlagBlocks (when n_order > 1);
// both: `ctl` holds the epoch and the count of finished blocks (0).
// A device-regime launch of one pass waits for no block, so it is an
// ordinary launch of any number of blocks.
template <typename T>
int dia_gs_sweep(const T* data, int ndiag, long long npad, const int* offsets,
                 int n, const T* b, const T* dinv, const int* colors,
                 const int* order, int n_order, T omega, const T* x0, T* out,
                 T* scratch, unsigned long long* words, unsigned* flags,
                 unsigned* ctl, int staged, int blocks, int threads,
                 int rows, int reach, int halo, int smem, void* stream) {
  if (n <= 0) return 0;
  const bool waits = n_order > 1;
  const bool bad =
      ndiag < 1 || npad < n || n_order < 1 || blocks < 1 || rows < 1 ||
      ctl == nullptr ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      static_cast<long long>(blocks) * rows < n ||
      static_cast<long long>(blocks - 1) * rows >= n || halo < 0 ||
      smem < gs_smem(staged, rows, ndiag, halo, sizeof(T)) ||
      smem > kMaxSmem ||
      (staged ? (waits && words == nullptr)
              : waits && (scratch == nullptr || flags == nullptr ||
                          blocks > kMaxFlagBlocks ||
                          static_cast<long long>(reach) * rows < halo));
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  if (staged) {
    // the 2-D 5-point operators get a kernel of their own width (the 2-D
    // 9-point one ran no faster in its own, and the 3-D 7-point one of
    // the main path reaches past the next block, so it is not staged)
    static int allowed[2] = {48 * 1024, 48 * 1024};
    auto run = [&](auto kernel, int* allowed_k) {
      return launch(kernel, true, allowed_k, blocks, threads, smem, stream,
                    data, npad, ndiag, offsets, n, b, dinv, colors, order,
                    n_order, omega, x0, out, words, ctl, rows, halo);
    };
#ifndef PYAMG_DIA_GS_GENERIC   // a build for a timing probe: any width
    if (ndiag == 5) return run(dia_gs_staged_kernel<T, 5>, &allowed[1]);
#endif
    return run(dia_gs_staged_kernel<T, 0>, &allowed[0]);
  }
  static int allowed = 48 * 1024;
  return launch(dia_gs_device_kernel<T>, waits, &allowed, blocks, threads,
                smem, stream, data, npad, ndiag, offsets, n, b, dinv, colors,
                order, n_order, omega, x0, out, scratch, flags, ctl, rows,
                reach, halo);
}

}  // namespace

extern "C" {

int pyamg_dia_spmv_capacity() { return kSpmvOffsets; }

int pyamg_dia_spmv_f32(const float* data, int ndiag, long long npad,
                       const int* host_offsets, const int* offsets, int n,
                       int k, const float* x, float* y, int threads,
                       int blocks, void* stream) {
  return dia_spmv<float>(data, ndiag, npad, host_offsets, offsets, n, k, x,
                         y, threads, blocks, stream);
}

int pyamg_dia_spmv_f64(const double* data, int ndiag, long long npad,
                       const int* host_offsets, const int* offsets, int n,
                       int k, const double* x, double* y, int threads,
                       int blocks, void* stream) {
  return dia_spmv<double>(data, ndiag, npad, host_offsets, offsets, n, k, x,
                          y, threads, blocks, stream);
}

int pyamg_dia_gs_sweep_f32(const float* data, int ndiag, long long npad,
                           const int* offsets, int n, const float* b,
                           const float* dinv, const int* colors,
                           const int* order, int n_order, float omega,
                           const float* x0, float* out, float* scratch,
                           unsigned long long* words, unsigned* flags,
                           unsigned* ctl, int staged, int blocks,
                           int threads, int rows, int reach, int halo,
                           int smem, void* stream) {
  return dia_gs_sweep<float>(data, ndiag, npad, offsets, n, b, dinv, colors,
                             order, n_order, omega, x0, out, scratch, words,
                             flags, ctl, staged, blocks, threads, rows,
                             reach, halo, smem, stream);
}

int pyamg_dia_gs_sweep_f64(const double* data, int ndiag, long long npad,
                           const int* offsets, int n, const double* b,
                           const double* dinv, const int* colors,
                           const int* order, int n_order, double omega,
                           const double* x0, double* out, double* scratch,
                           unsigned long long* words, unsigned* flags,
                           unsigned* ctl, int staged, int blocks,
                           int threads, int rows, int reach, int halo,
                           int smem, void* stream) {
  return dia_gs_sweep<double>(data, ndiag, npad, offsets, n, b, dinv, colors,
                              order, n_order, omega, x0, out, scratch, words,
                              flags, ctl, staged, blocks, threads, rows,
                              reach, halo, smem, stream);
}

}  // extern "C"
