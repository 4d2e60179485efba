// The sparse products of the distributed V-cycle, hand-written for Hopper
// (sm_90a).
//
// K6 dist_slice_apply: y = A src over a sliced layout, with one vector
//   update fused after the product, chosen by a mode:
//     0 apply     y = A src
//     1 residual  y = b - A src
//     2 jacobi    y = x + w (b - A src)       (w = omega / diag, by row)
//     3 correct   y = x + A src               (A the prolongation P)
//     4 jacobi0   y = 0 + w (b - 0)           (the sweep from x = 0: no
//                                              product, src not read)
//   Every product of DistHierarchy's solve phase is one launch
//   (pyamg_tpu_torch/parallel/dist_setup.py: the smoother's sweeps, the
//   residual, the restriction R r, the correction x + P xc and the Krylov
//   loops' A p).  Replaces no TPU kernel: the JAX package writes these
//   products as jnp gathers over the padded level arrays
//   (pyamg_tpu/parallel/dist_setup.py:87-125), which XLA fuses into one
//   pass; in eager torch ops they were ~1,280 unfused launches a CG
//   iteration at 1414^2, each building (rows x width) temporaries.
//
// The layout (ops/dist_kernels.py, SliceLayout), built once a hierarchy:
// rows in slices of 32, one warp a slice; a slice is as wide as the most
// stored entries among its rows; a row's stored entries are packed to the
// front in their stored order; within a slice the entries are
// column-major, so slot k of the 32 rows is 32 contiguous values and 32
// contiguous int32 columns.  sptr[s] is the first entry of slice s
// (int64); its width is (sptr[s + 1] - sptr[s]) / 32.  A padding slot
// (past its row's count) holds the value 0 and a column of its own row
// (0 for a row with none), so every lane walks the slice's whole width
// with no branch of its own and never gathers out of range; the product
// 0 * src[col] adds +0 or -0, which leaves the sum as it was (a sum that
// starts at +0 is never -0).  Columns index `src`, the vector the product
// reads: the process's own rows where its ranks hold every margin (a
// StackedMesh, a one-rank RowMesh), else the margin-extended block
// [prev_g | local | next_g].
//
// Bound: device-memory bytes.  A product reads its stored entries (4-byte
// column, 4- or 8-byte value) once, plus src (L2-resident at these sizes:
// 8 MB at 1414^2 level 0), the epilogue's vectors and y: ~2 flops per 8
// bytes.  Each thread owns one row and walks its slice's slots in order,
// four at a time: the columns and values of the four are loaded, then the
// four gathers of src, then the four products are added in order, so a
// thread has up to 12 loads in flight.  Groups of 4 measured faster than
// of 8 and 16 at 1414^2 (fewer registers, more warps resident:
// probes/k6_variants.py, PERF.md section 6).  The width is the same for
// the 32 lanes of a warp, so the predicates on the last group do not
// diverge.
//
// Arithmetic equals the plain version's bit for bit: acc starts at 0,
// each product is rounded (mul_rn) and added in slot order (add_rn); the
// epilogue is b - acc, w * (b - acc), x + (...), each rounded, in that
// association.  No contraction into FMA.  jacobi0 is jacobi from a zero x
// (every V-cycle's first sweep on each level): A 0 sums to +0 for any
// finite A, b - (+0) is b, so y = 0 + w * b, and the level's matrix is not
// read.
//
// C ABI (loaded with ctypes): the entry point checks its arguments and
// launch shape, launches on the given stream, does not synchronise,
// allocates nothing, and returns a CUDA error code (0 on success).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxThreads = 256;    // a block, at most (ops: MAX_THREADS)
// slots a thread loads before it adds; a build for a timing probe may
// take another (probes/k6_variants.py)
#ifndef PYAMG_DIST_GROUP
#define PYAMG_DIST_GROUP 4
#endif
constexpr int kGroup = PYAMG_DIST_GROUP;

// the layout's columns and values: read-only loads
template <typename T>
__device__ __forceinline__ T load_entry(const T* p) {
  return __ldg(p);
}

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

enum Mode {
  kApply = 0,
  kResidual = 1,
  kJacobi = 2,
  kCorrect = 3,
  kJacobiZero = 4
};

// thread t of the launch owns row t: blocks are whole warps, so the 32
// lanes of a warp are the 32 rows of slice t / 32
template <typename T, int kMode>
__global__ void __launch_bounds__(kMaxThreads)
    slice_apply_kernel(const int* __restrict__ cols,
                       const T* __restrict__ vals,
                       const long long* __restrict__ sptr, int rows,
                       const T* __restrict__ src, const T* __restrict__ x,
                       const T* __restrict__ b, const T* __restrict__ w,
                       T* __restrict__ y) {
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  if (kMode == kJacobiZero) {
    // A 0 sums to +0, and b - (+0) is b
    y[row] = Rn<T>::add(T(0), Rn<T>::mul(w[row], b[row]));
    return;
  }
  const long long s = row >> 5;
  const long long lo = __ldg(sptr + s);
  const int width = static_cast<int>((__ldg(sptr + s + 1) - lo) >> 5);
  const long long at = lo + (row & 31);
  const int* c = cols + at;
  const T* v = vals + at;
  T acc = T(0);
  for (int k = 0; k < width; k += kGroup) {
    int ci[kGroup];
    T vi[kGroup], xi[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (k + u < width) {
        ci[u] = load_entry(c + 32 * u);
        vi[u] = load_entry(v + 32 * u);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (k + u < width) xi[u] = __ldg(src + ci[u]);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (k + u < width) acc = Rn<T>::add(acc, Rn<T>::mul(vi[u], xi[u]));
    }
    c += 32 * kGroup;
    v += 32 * kGroup;
  }
  T out = acc;
  if (kMode == kResidual) {
    out = Rn<T>::sub(b[row], acc);
  } else if (kMode == kJacobi) {
    out = Rn<T>::add(x[row], Rn<T>::mul(w[row], Rn<T>::sub(b[row], acc)));
  } else if (kMode == kCorrect) {
    out = Rn<T>::add(x[row], acc);
  }
  y[row] = out;
}

template <typename T, int kMode>
int launch(int blocks, int threads, void* stream, const int* cols,
           const T* vals, const long long* sptr, int rows, const T* src,
           const T* x, const T* b, const T* w, T* y) {
  slice_apply_kernel<T, kMode>
      <<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          cols, vals, sptr, rows, src, x, b, w, y);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int slice_apply(const int* cols, const T* vals, const long long* sptr,
                int rows, const T* src, const T* x, const T* b, const T* w,
                T* y, int mode, int threads, int blocks, void* stream) {
  if (rows == 0) return 0;
  const bool needs_b = mode == kResidual || mode == kJacobi ||
                       mode == kJacobiZero;
  const bool needs_x = mode == kJacobi || mode == kCorrect;
  const bool needs_w = mode == kJacobi || mode == kJacobiZero;
  const bool bad =
      rows < 0 || mode < kApply || mode > kJacobiZero || cols == nullptr ||
      vals == nullptr || sptr == nullptr ||
      (src == nullptr && mode != kJacobiZero) || y == nullptr ||
      (needs_b && b == nullptr) || (needs_x && x == nullptr) ||
      (needs_w && w == nullptr) || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || blocks < 1 ||
      static_cast<long long>(blocks) * threads < rows ||
      static_cast<long long>(blocks - 1) * threads >= rows;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kApply:
      return launch<T, kApply>(blocks, threads, stream, cols, vals, sptr,
                               rows, src, x, b, w, y);
    case kResidual:
      return launch<T, kResidual>(blocks, threads, stream, cols, vals, sptr,
                                  rows, src, x, b, w, y);
    case kJacobi:
      return launch<T, kJacobi>(blocks, threads, stream, cols, vals, sptr,
                                rows, src, x, b, w, y);
    case kJacobiZero:
      return launch<T, kJacobiZero>(blocks, threads, stream, cols, vals,
                                    sptr, rows, src, x, b, w, y);
    default:
      return launch<T, kCorrect>(blocks, threads, stream, cols, vals, sptr,
                                 rows, src, x, b, w, y);
  }
}

}  // namespace

extern "C" {

int pyamg_dist_slice_apply_f32(const int* cols, const float* vals,
                               const long long* sptr, int rows,
                               const float* src, const float* x,
                               const float* b, const float* w, float* y,
                               int mode, int threads, int blocks,
                               void* stream) {
  return slice_apply<float>(cols, vals, sptr, rows, src, x, b, w, y, mode,
                            threads, blocks, stream);
}

int pyamg_dist_slice_apply_f64(const int* cols, const double* vals,
                               const long long* sptr, int rows,
                               const double* src, const double* x,
                               const double* b, const double* w, double* y,
                               int mode, int threads, int blocks,
                               void* stream) {
  return slice_apply<double>(cols, vals, sptr, rows, src, x, b, w, y, mode,
                             threads, blocks, stream);
}

}  // extern "C"
