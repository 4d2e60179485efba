// The block (BELL) products and block smoother passes of the solve phase,
// hand-written for Hopper (sm_90a).
//
// K7 bell_apply: y = A x over a block sliced layout, one thread a block
//   row, with one update fused after the product, chosen by a mode:
//     0 apply     y_i = (A x)_i
//     1 residual  y_i = b_i - (A x)_i
//     2 relax     y_i = x_i + omega Dinv_i (b_i - (A x)_i)   (square blocks)
//   on the layout rows [row0, row0 + nrows) (ops/bell_kernels.py: a whole
//   operator, or one color's block rows), and with a mask only on the
//   block rows it marks.  relax is both block smoothers' pass: a block
//   Gauss-Seidel color pass writes y = x in place on the rows of one color
//   (gs_color), block Jacobi a new y on every row or, into a copy of x,
//   on the rows of a mask (jacobi).  Every block product and block
//   smoother pass of a placed hierarchy is one launch (ops/spmv.py: bspmv,
//   residual; relaxation/relaxation.py: the block smoothers), the level
//   products, the residual, R, P and the Krylov loops' A p among them.
//   Replaces no TPU kernel: the JAX package's bspmv is a jnp.einsum
//   (pyamg_tpu/ops/spmv.py:64-81), and its color pass a full einsum
//   product and a masked update, which XLA fuses.  As
//   torch ops on the card the einsum was cuBLAS's batched gemv over
//   (1 x W*bc) products, after a permuting copy of the blocks and a gather
//   of x's blocks, and each color pass computed every block row of A to
//   keep one color's.
//
// The layout (ops/bell_kernels.py, BellLayout), built once an operator
// at set-up (MultilevelSolver.to_device): the block rows in groups (one
// group, in order, for the products; one group a color for Gauss-Seidel
// over the level's operator, whose products read it too), each
// group in whole slices of 32 layout rows, one warp a slice; rowmap[lr]
// is the block row of layout row lr (-1 for the unused lanes of a
// group's last slice; no rowmap: the identity).  Every slice is as wide
// as the BELL (width slots, as its padded rows are): slot k of lane l of
// slice s holds its int32 block column at cols[(s width + k) 32 + l] and
// its block, row-major, component e at vals[(s width + k) 32 BB + 32 e +
// l] (BB = BR BC): each load of a warp is 32 contiguous values.  A
// padding slot holds a zero block and the column of its row's first
// stored block (its own row for a square BELL's empty row), so every lane
// walks the same width and never reads out of range.  dinv, for relax, is
// the smoother's own (nb, BR, BR) array, read at block row r (BR BR
// values in a row, as x, b and y are read at r): a color's rows are not
// contiguous, so a warp reads 32 short runs, a small share of a pass's
// bytes (16 of ~200 a row at the benchmark's level 0), where a packed
// copy would be a second array to keep beside every Dinv.  x's blocks
// are read in place (x is 4 MB at the benchmark's level 0, inside the
// 50 MB L2); nothing is gathered or permuted.
//
// In-place Gauss-Seidel is exact: the coloring is proper on the block
// graph, so a row's stored columns of its own color are its diagonal
// block alone.  The only x the threads of a color pass write is their own
// rows', which no other thread of the pass reads, and each thread reads
// its diagonal block's x before it writes.  The layout build checks the
// coloring and raises where it is not proper.
//
// Bound: device-memory bytes.  A product reads each slot's block and
// int32 column once, plus x, the update's vectors and y: at the
// benchmark's level 0 (501,264 block rows of 2 x 2, 9 slots) 4.5 M slots
// x 20 B + 12 MB = 98 MB, 29.3 us at 3.35 TB/s; a level-0 color pass
// reads its color's slab (~1/4) plus its Dinv, b and x rows, ~27 MB, ~8
// us.  The coarse levels (55,696 and 6,241 block rows) are launch-bound.
// Each thread walks its slots four at a time: the columns and blocks of
// the four are loaded, then x's four blocks, then the products are added
// in slot order (as K6, csrc/dist_kernels.cu): up to 4 (BB + 1 + BC)
// loads in flight a thread.  A launch is one thread a layout row of its
// range; the lanes past a group's rows and the rows off the mask return.
//
// Arithmetic: each output sums its slots in stored order, each block row
// by row, with the compiler's contractions (FMA); the plain version is the
// einsum of the torch formula, whose order is the library's, so the two
// agree to float rounding, not bit for bit.
//
// Block sides 1 to 3 are template parameters: apply for every pair, the
// residual and relax for the square ones.  Any other sides take a kernel
// of runtime sides (one slot at a time): up to kMaxSide block rows in
// registers; wider blocks kMaxSide of their rows at a time, a pass over
// the row's slots each, relax putting the residual into a work vector
// (nb BR values, the caller's) before it applies Dinv.
//
// C ABI (loaded with ctypes): the entry point checks its arguments and
// launch shape, launches on the given stream, does not synchronise,
// allocates nothing, and returns a CUDA error code (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // a block, at most (ops: MAX_THREADS)
constexpr int kGroup = 4;         // slots a thread loads before it adds
constexpr int kMaxSide = 8;       // block rows a thread sums in registers

enum Mode { kApply = 0, kResidual = 1, kRelax = 2 };

// the block row of launch thread t, or -1 for none
__device__ __forceinline__ int block_row(const int* rowmap,
                                         const unsigned char* mask, int row0,
                                         int nrows, int nb, int* lr) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nrows) return -1;
  *lr = row0 + t;
  const int r = rowmap ? __ldg(rowmap + *lr) : *lr;
  if (r < 0 || r >= nb || (mask && !__ldg(mask + r))) return -1;
  return r;
}

// the update after the product, for block row r of BR outputs; x may be
// y (a color pass in place): x's row is read first
template <typename T, int kMode, int BR>
__device__ __forceinline__ void epilogue(const T* acc, int r, const T* x,
                                         const T* b,
                                         const T* dinv, T omega, T* y,
                                         int br) {
  const long long o = static_cast<long long>(r) * br;
  if (kMode == kApply) {
#pragma unroll
    for (int i = 0; i < BR; ++i)
      if (i < br) y[o + i] = acc[i];
  } else if (kMode == kResidual) {
#pragma unroll
    for (int i = 0; i < BR; ++i)
      if (i < br) y[o + i] = __ldg(b + o + i) - acc[i];
  } else {
    T res[BR], out[BR];
#pragma unroll
    for (int i = 0; i < BR; ++i)
      if (i < br) res[i] = __ldg(b + o + i) - acc[i];
    const T* d = dinv + o * br;
#pragma unroll
    for (int i = 0; i < BR; ++i) {
      if (i < br) {
        T di = T(0);
#pragma unroll
        for (int j = 0; j < BR; ++j)
          if (j < br) di += __ldg(d + i * br + j) * res[j];
        out[i] = x[o + i] + omega * di;
      }
    }
#pragma unroll
    for (int i = 0; i < BR; ++i)
      if (i < br) y[o + i] = out[i];
  }
}

// blocks of BR x BC, known at compile time
template <typename T, int BR, int BC, int kMode>
__global__ void __launch_bounds__(kMaxThreads)
    bell_fixed_kernel(const int* __restrict__ cols,
                      const T* __restrict__ vals, int width,
                      const int* __restrict__ rowmap,
                      const unsigned char* __restrict__ mask, int row0,
                      int nrows, int nb, const T* x,
                      const T* __restrict__ b, const T* __restrict__ dinv,
                      T omega, T* y) {
  constexpr int BB = BR * BC;
  int lr = 0;
  const int r = block_row(rowmap, mask, row0, nrows, nb, &lr);
  if (r < 0) return;
  const long long lo = static_cast<long long>(lr >> 5) * width * 32;
  const int* c = cols + lo + (lr & 31);
  const T* v = vals + lo * BB + (lr & 31);
  T acc[BR];
#pragma unroll
  for (int i = 0; i < BR; ++i) acc[i] = T(0);
  for (int k = 0; k < width; k += kGroup) {
    int ci[kGroup];
    T vi[kGroup][BB], xi[kGroup][BC];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (k + u < width) {
        ci[u] = __ldg(c + 32 * u);
#pragma unroll
        for (int e = 0; e < BB; ++e) vi[u][e] = __ldg(v + 32 * (u * BB + e));
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (k + u < width) {
        const T* xb = x + static_cast<long long>(ci[u]) * BC;
#pragma unroll
        for (int j = 0; j < BC; ++j) xi[u][j] = __ldg(xb + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (k + u < width) {
#pragma unroll
        for (int i = 0; i < BR; ++i)
#pragma unroll
          for (int j = 0; j < BC; ++j) acc[i] += vi[u][i * BC + j] * xi[u][j];
      }
    }
    c += 32 * kGroup;
    v += 32 * kGroup * BB;
  }
  epilogue<T, kMode, BR>(acc, r, x, b, dinv, omega, y, BR);
}

// rows [i0, i0 + n) (n <= kMaxSide) of a block row's product into acc,
// one slot at a time (c, v: the row's first slot in the layout)
template <typename T>
__device__ __forceinline__ void slot_rows(const int* c, const T* v,
                                          int width, int bb, int bc, int i0,
                                          int n, const T* x, T* acc) {
#pragma unroll
  for (int i = 0; i < kMaxSide; ++i) acc[i] = T(0);
  for (int k = 0; k < width; ++k) {
    const T* xb = x + static_cast<long long>(__ldg(c + 32LL * k)) * bc;
    const T* vk = v + 32LL * k * bb;
#pragma unroll
    for (int i = 0; i < kMaxSide; ++i)
      if (i < n)
        for (int j = 0; j < bc; ++j)
          acc[i] += __ldg(vk + 32 * ((i0 + i) * bc + j)) * __ldg(xb + j);
  }
}

// blocks of br x bc sides given at run time: up to kMaxSide block rows
// summed in registers; wider blocks kMaxSide of their rows at a time, a
// pass over the row's slots each, relax putting the residual into work
// (plain loads: this thread wrote it) before it applies Dinv
template <typename T, int kMode>
__global__ void __launch_bounds__(kMaxThreads)
    bell_any_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                    int width, const int* __restrict__ rowmap,
                    const unsigned char* __restrict__ mask, int row0,
                    int nrows, int nb, int br, int bc, const T* x,
                    const T* __restrict__ b, const T* __restrict__ dinv,
                    T omega, T* y, T* work) {
  const int bb = br * bc;
  int lr = 0;
  const int r = block_row(rowmap, mask, row0, nrows, nb, &lr);
  if (r < 0) return;
  const long long lo = static_cast<long long>(lr >> 5) * width * 32;
  const int* c = cols + lo + (lr & 31);
  const T* v = vals + lo * bb + (lr & 31);
  T acc[kMaxSide];
  if (br <= kMaxSide) {
    slot_rows(c, v, width, bb, bc, 0, br, x, acc);
    epilogue<T, kMode, kMaxSide>(acc, r, x, b, dinv, omega, y, br);
    return;
  }
  const long long o = static_cast<long long>(r) * br;
  for (int i0 = 0; i0 < br; i0 += kMaxSide) {
    const int n = min(kMaxSide, br - i0);
    slot_rows(c, v, width, bb, bc, i0, n, x, acc);
#pragma unroll
    for (int i = 0; i < kMaxSide; ++i) {
      if (i < n) {
        const long long at = o + i0 + i;
        if (kMode == kApply)
          y[at] = acc[i];
        else if (kMode == kResidual)
          y[at] = __ldg(b + at) - acc[i];
        else
          work[at] = __ldg(b + at) - acc[i];
      }
    }
  }
  if (kMode == kRelax) {
    const T* d = dinv + o * br;
    for (int i = 0; i < br; ++i) {
      T di = T(0);
      for (int j = 0; j < br; ++j) di += __ldg(d + i * br + j) * work[o + j];
      y[o + i] = x[o + i] + omega * di;
    }
  }
}

struct Args {
  int blocks, threads;
  cudaStream_t stream;
  const int* cols;
  int width;
  const int* rowmap;
  const unsigned char* mask;
  int row0, nrows, nb;
};

template <typename T, int BR, int BC, int kMode>
int launch_fixed(const Args& a, const T* vals, const T* x, const T* b,
                 const T* dinv, T omega, T* y) {
  bell_fixed_kernel<T, BR, BC, kMode><<<a.blocks, a.threads, 0, a.stream>>>(
      a.cols, vals, a.width, a.rowmap, a.mask, a.row0, a.nrows, a.nb, x, b,
      dinv, omega, y);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kMode>
int launch_any(const Args& a, int br, int bc, const T* vals, const T* x,
               const T* b, const T* dinv, T omega, T* y, T* work) {
  bell_any_kernel<T, kMode><<<a.blocks, a.threads, 0, a.stream>>>(
      a.cols, vals, a.width, a.rowmap, a.mask, a.row0, a.nrows, a.nb, br, bc,
      x, b, dinv, omega, y, work);
  return static_cast<int>(cudaGetLastError());
}

#define PYAMG_BELL_FIXED(R, C, M)                                        \
  if (br == R && bc == C && mode == M)                                  \
  return launch_fixed<T, R, C, M>(a, vals, x, b, dinv, static_cast<T>(omega), \
                                  y)

template <typename T>
int bell_apply(const int* cols, const T* vals, int width, const int* rowmap,
               int row0, int nrows, int nb, int br, int bc, const T* x,
               const T* b, const T* dinv, const unsigned char* mask,
               double omega, T* y, T* work, int mode, int threads,
               int blocks, void* stream) {
  if (nrows == 0) return 0;
  const bool bad =
      nrows < 0 || row0 < 0 || nb < 0 || width < 0 || br < 1 || bc < 1 ||
      mode < kApply || mode > kRelax ||
      (width > 0 && (cols == nullptr || vals == nullptr)) ||
      x == nullptr || y == nullptr || (mode != kApply && b == nullptr) ||
      (mode == kRelax && (dinv == nullptr || br != bc ||
                          (br > kMaxSide && work == nullptr))) ||
      threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || blocks < 1 ||
      static_cast<long long>(blocks) * threads < nrows ||
      static_cast<long long>(blocks - 1) * threads >= nrows;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{blocks, threads, static_cast<cudaStream_t>(stream), cols,
               width, rowmap, mask, row0, nrows, nb};
  PYAMG_BELL_FIXED(1, 1, kApply);
  PYAMG_BELL_FIXED(2, 2, kApply);
  PYAMG_BELL_FIXED(3, 3, kApply);
  PYAMG_BELL_FIXED(1, 2, kApply);
  PYAMG_BELL_FIXED(2, 1, kApply);
  PYAMG_BELL_FIXED(1, 3, kApply);
  PYAMG_BELL_FIXED(3, 1, kApply);
  PYAMG_BELL_FIXED(2, 3, kApply);
  PYAMG_BELL_FIXED(3, 2, kApply);
  PYAMG_BELL_FIXED(1, 1, kResidual);
  PYAMG_BELL_FIXED(2, 2, kResidual);
  PYAMG_BELL_FIXED(3, 3, kResidual);
  PYAMG_BELL_FIXED(1, 1, kRelax);
  PYAMG_BELL_FIXED(2, 2, kRelax);
  PYAMG_BELL_FIXED(3, 3, kRelax);
  const T w = static_cast<T>(omega);
  switch (mode) {
    case kApply:
      return launch_any<T, kApply>(a, br, bc, vals, x, b, dinv, w, y,
                                  work);
    case kResidual:
      return launch_any<T, kResidual>(a, br, bc, vals, x, b, dinv, w, y,
                                  work);
    default:
      return launch_any<T, kRelax>(a, br, bc, vals, x, b, dinv, w, y,
                                  work);
  }
}

#undef PYAMG_BELL_FIXED

}  // namespace

extern "C" {

int pyamg_bell_apply_f32(const int* cols, const float* vals, int width,
                         const int* rowmap, int row0, int nrows, int nb,
                         int br, int bc, const float* x, const float* b,
                         const float* dinv, const unsigned char* mask,
                         double omega, float* y, float* work, int mode,
                         int threads, int blocks, void* stream) {
  return bell_apply<float>(cols, vals, width, rowmap, row0, nrows, nb, br,
                           bc, x, b, dinv, mask, omega, y, work, mode,
                           threads, blocks, stream);
}

int pyamg_bell_apply_f64(const int* cols, const double* vals, int width,
                         const int* rowmap, int row0, int nrows, int nb,
                         int br, int bc, const double* x, const double* b,
                         const double* dinv, const unsigned char* mask,
                         double omega, double* y, double* work, int mode,
                         int threads, int blocks, void* stream) {
  return bell_apply<double>(cols, vals, width, rowmap, row0, nrows, nb, br,
                            bc, x, b, dinv, mask, omega, y, work, mode,
                            threads, blocks, stream);
}

}  // extern "C"
