// Banded (DIA) kernels of the solve phase, hand-written for Hopper (sm_90a).
//
// K1 dia_spmv: y[i] = sum_d data[d, i] * x[i + off_d], x read as 0 outside
//   [0, n).  Replaces pyamg_tpu/ops/pallas_kernels.py:_dia_call (the fused
//   TPU banded SpMV behind dia_spmv_pallas).
// K2 dia_gs_pass: one pass of multicolor Gauss-Seidel on a DIA operator:
//   every row i with colors[i] == color gets
//   x_i += (omega * Dinv_i) * (b_i - (A x)_i) from the current x.  The
//   sweep (a sequence of passes) replaces
//   pyamg_tpu/ops/pallas_kernels.py:_dia_gs_call, which ran all passes in
//   one TPU grid with x resident in VMEM.
//
// Both are bound by device-memory bytes: K1 reads ndiag*n matrix values
// plus x and writes y, about 2 flops per 4-8 bytes; one K2 pass reads
// ndiag*n values plus b, Dinv, colors and x and writes x.  The simple
// design: one thread per row, the diagonal loop reads data[d, i] coalesced
// along i, and the few x reads of a warp overlap in L1/L2 (neighbouring
// rows read neighbouring x).  No shared memory, no tiling: a later change
// may stage x tiles or fuse passes.
//
// In-place update within a K2 pass is safe.  First-fit coloring over a
// symmetric stored pattern gives no two rows of one color a stored entry
// between them, so a row of color c reads only neighbour values that no
// other thread of the same pass writes.  The DIA band may hold explicit
// zeros at positions that are not stored entries; a neighbour read there
// may be mid-update, but it is multiplied by 0.
//
// C ABI (loaded with ctypes): every entry point returns cudaGetLastError()
// (or the first failing call's code), launches on the given stream, does
// not synchronise and allocates nothing.  Offsets and the pass order are
// host arrays, copied into kernel arguments.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 64;
constexpr int kThreads = 256;

struct Offsets {
  int v[kMaxDiags];
};

template <typename T>
__device__ __forceinline__ T band_product(const T* __restrict__ data,
                                          long long npad, int ndiag,
                                          const Offsets& offs, int n, int i,
                                          const T* x) {
  T acc = T(0);
  for (int d = 0; d < ndiag; ++d) {
    const int j = i + offs.v[d];
    const T xv = (j >= 0 && j < n) ? x[j] : T(0);
    acc += data[(long long)d * npad + i] * xv;
  }
  return acc;
}

template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ data, long long npad,
                                int ndiag, Offsets offs, int n,
                                const T* __restrict__ x, T* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  y[i] = band_product(data, npad, ndiag, offs, n, i, x);
}

template <typename T>
__global__ void dia_gs_pass_kernel(const T* __restrict__ data, long long npad,
                                   int ndiag, Offsets offs, int n,
                                   const T* __restrict__ b,
                                   const T* __restrict__ dinv,
                                   const int* __restrict__ colors, int color,
                                   T omega, T* x) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || colors[i] != color) return;
  // x is written by this pass, so it is read through the coherent path
  const T r = b[i] - band_product(data, npad, ndiag, offs, n, i,
                                  static_cast<const T*>(x));
  x[i] = x[i] + omega * dinv[i] * r;
}

int load_offsets(const int* offsets, int ndiag, Offsets* offs) {
  if (ndiag < 1 || ndiag > kMaxDiags) return (int)cudaErrorInvalidValue;
  for (int d = 0; d < ndiag; ++d) offs->v[d] = offsets[d];
  for (int d = ndiag; d < kMaxDiags; ++d) offs->v[d] = 0;
  return 0;
}

template <typename T>
int dia_spmv(const T* data, int ndiag, long long npad, const int* offsets,
             int n, const T* x, T* y, void* stream) {
  Offsets offs;
  int rc = load_offsets(offsets, ndiag, &offs);
  if (rc) return rc;
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  dia_spmv_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      data, npad, ndiag, offs, n, x, y);
  return (int)cudaGetLastError();
}

template <typename T>
int dia_gs_sweep(const T* data, int ndiag, long long npad, const int* offsets,
                 int n, const T* b, const T* dinv, const int* colors,
                 const int* order, int n_order, T omega, const T* x0, T* x,
                 void* stream) {
  Offsets offs;
  int rc = load_offsets(offsets, ndiag, &offs);
  if (rc) return rc;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  rc = (int)cudaMemcpyAsync(x, x0, sizeof(T) * (size_t)n,
                            cudaMemcpyDeviceToDevice, s);
  if (rc) return rc;
  const int blocks = (n + kThreads - 1) / kThreads;
  for (int p = 0; p < n_order; ++p) {
    dia_gs_pass_kernel<T><<<blocks, kThreads, 0, s>>>(
        data, npad, ndiag, offs, n, b, dinv, colors, order[p], omega, x);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

int pyamg_dia_spmv_f32(const float* data, int ndiag, long long npad,
                       const int* offsets, int n, const float* x, float* y,
                       void* stream) {
  return dia_spmv<float>(data, ndiag, npad, offsets, n, x, y, stream);
}

int pyamg_dia_spmv_f64(const double* data, int ndiag, long long npad,
                       const int* offsets, int n, const double* x, double* y,
                       void* stream) {
  return dia_spmv<double>(data, ndiag, npad, offsets, n, x, y, stream);
}

int pyamg_dia_gs_sweep_f32(const float* data, int ndiag, long long npad,
                           const int* offsets, int n, const float* b,
                           const float* dinv, const int* colors,
                           const int* order, int n_order, float omega,
                           const float* x0, float* x, void* stream) {
  return dia_gs_sweep<float>(data, ndiag, npad, offsets, n, b, dinv, colors,
                             order, n_order, omega, x0, x, stream);
}

int pyamg_dia_gs_sweep_f64(const double* data, int ndiag, long long npad,
                           const int* offsets, int n, const double* b,
                           const double* dinv, const int* colors,
                           const int* order, int n_order, double omega,
                           const double* x0, double* x, void* stream) {
  return dia_gs_sweep<double>(data, ndiag, npad, offsets, n, b, dinv, colors,
                              order, n_order, omega, x0, x, stream);
}

}  // extern "C"
