// SELL (shift-ELL) kernels of the solve phase, hand-written for Hopper
// (sm_90a).  The plan (sparse/sell.py) stores, per pass p and padded row
// i, a value vals[p, i] and a local column delta[p, i]; the column is
//
//   c = 128 * (anchor(i / 128) + bases[p]) + delta[p, i],
//
// anchor(s) = s / t for a tall operator (t = 1: square), s * t for a fat
// one.  Slots outside the logical rows, or whose column falls outside
// [0, m), contribute nothing (the reference reads a zero-padded x there,
// and such slots hold the value 0).
//
// K3/K4 sell_spmv: y[i] = sum over p, in pass order, of vals[p, i] * x[c].
//   Replaces pyamg_tpu/ops/sell_kernels.py:_spmv_call (K3, x resident in
//   VMEM) and :_spmv_tiled_call (K4, x streamed in row tiles once it
//   passes the TPU's 6 MB VMEM budget).  Both were TPU layout work around
//   one gather (row-expanded or decimated x, shifted lane-gather windows);
//   Hopper reads x[c] from device memory at any size, so one kernel does
//   both regimes.
// K5 sell_gs_sweep: one directional hybrid Gauss-Seidel sweep on a square
//   SELL.  Replaces pyamg_tpu/ops/sell_kernels.py:_gs_call.  1024-row
//   tiles are visited in order (or reversed); within a tile every row
//   computes r = b - sum_p vals * x[c], subtracting pass by pass, from the
//   x at tile entry, and then x += (omega * Dinv) * r.  Rows of earlier
//   tiles are read updated, rows of later tiles old.
//
// Both are bound by device-memory bytes: per pass and row they read a
// 4-byte value, a 4-byte delta and (for a stored entry) a 4-byte x, for 2
// flops.  The simple design: one thread per row, passes in order, the
// pass's value and delta read coalesced along i ((T, Sy*128) row-major);
// loads of kUnroll passes are issued before their sums so that their
// latencies overlap.  Slots holding 0 skip their delta and x reads.
// K5 is one block of 1024 threads that walks the tiles, with x in device
// memory: each tile is a phase of reads and a phase of writes, each ended
// by __syncthreads().  It runs on one of 132 SMs: right, not fast.
//
// The products and sums are rounded one by one (__fmul_rn, __fadd_rn,
// __fsub_rn: no contraction into FMA), so the kernels compute what their
// plain PyTorch versions compute, in the same order.
//
// C ABI (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;
constexpr int kGsTile = 1024;       // 8 sublanes x 128 lanes, as the reference
constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// x[c] for the slot (p, i), 0 when the slot is empty or c is outside [0, m)
__device__ __forceinline__ float slot_x(float v, const int* __restrict__ delta,
                                        long long off, int col0, int base,
                                        int m, const float* x) {
  if (v == 0.f) return 0.f;
  const int c = col0 + kLane * base + delta[off];
  return (c >= 0 && c < m) ? x[c] : 0.f;
}

__global__ void sell_spmv_kernel(const float* __restrict__ vals,
                                 const int* __restrict__ delta,
                                 const int* __restrict__ bases, int T,
                                 long long S, int n, int m, int t, int fat,
                                 const float* __restrict__ x,
                                 float* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int sigma = i / kLane;
  const int col0 = kLane * (fat ? sigma * t : sigma / t);
  float acc = 0.f;
  int p = 0;
  for (; p + kUnroll <= T; p += kUnroll) {
    float v[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = vals[(long long)(p + u) * S + i];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      xv[u] = slot_x(v[u], delta, (long long)(p + u) * S + i, col0,
                     bases[p + u], m, x);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, __fmul_rn(v[u], xv[u]));
  }
  for (; p < T; ++p) {
    const float v = vals[(long long)p * S + i];
    acc = __fadd_rn(acc, __fmul_rn(v, slot_x(v, delta, (long long)p * S + i,
                                             col0, bases[p], m, x)));
  }
  y[i] = acc;
}

__global__ void __launch_bounds__(kGsTile)
sell_gs_kernel(const float* __restrict__ vals, const int* __restrict__ delta,
               const int* __restrict__ bases, int T, long long S, int n,
               const float* __restrict__ b, const float* __restrict__ dinv,
               float omega, int reverse, float* x) {
  const int ntiles = (n + kGsTile - 1) / kGsTile;
  for (int k = 0; k < ntiles; ++k) {
    const int tile = reverse ? ntiles - 1 - k : k;
    const int i = tile * kGsTile + threadIdx.x;
    const bool live = i < n;
    float xnew = 0.f;
    if (live) {
      // x is written by this kernel: read through the coherent path
      const int col0 = kLane * (i / kLane);
      float r = b[i];
      int p = 0;
      for (; p + kUnroll <= T; p += kUnroll) {
        float v[kUnroll], xv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          v[u] = vals[(long long)(p + u) * S + i];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          xv[u] = slot_x(v[u], delta, (long long)(p + u) * S + i, col0,
                         bases[p + u], n, x);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          r = __fsub_rn(r, __fmul_rn(v[u], xv[u]));
      }
      for (; p < T; ++p) {
        const float v = vals[(long long)p * S + i];
        r = __fsub_rn(r, __fmul_rn(v, slot_x(v, delta, (long long)p * S + i,
                                             col0, bases[p], n, x)));
      }
      xnew = __fadd_rn(x[i], __fmul_rn(__fmul_rn(omega, dinv[i]), r));
    }
    __syncthreads();          // every row of the tile has read tile-entry x
    if (live) x[i] = xnew;
    __syncthreads();          // the tile's writes are seen by the next tile
  }
}

}  // namespace

extern "C" {

int pyamg_sell_spmv_f32(const float* vals, const int* delta, const int* bases,
                        int T, long long S, int n, int m, int t, int fat,
                        const float* x, float* y, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  sell_spmv_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      vals, delta, bases, T, S, n, m, t, fat, x, y);
  return (int)cudaGetLastError();
}

int pyamg_sell_gs_sweep_f32(const float* vals, const int* delta,
                            const int* bases, int T, long long S, int n,
                            const float* b, const float* dinv, float omega,
                            int reverse, float* x, void* stream) {
  if (n <= 0) return 0;
  sell_gs_kernel<<<1, kGsTile, 0, (cudaStream_t)stream>>>(
      vals, delta, bases, T, S, n, b, dinv, omega, reverse, x);
  return (int)cudaGetLastError();
}

}  // extern "C"
