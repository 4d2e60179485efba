// SELL (shift-ELL) kernels of the solve phase, hand-written for Hopper
// (sm_90a).  The plan (sparse/sell.py) stores, per pass p and padded row
// i, a value vals[p, i] and a local column delta[p, i], both (T, Sy*128)
// row-major; the column is
//
//   c = 128 * (anchor(i / 128) + bases[p]) + delta[p, i],
//
// anchor(s) = s / t for a tall operator (t = 1: square), s * t for a fat
// one.  A column outside [0, m) reads 0, as the reference reads its
// zero-padded x there.  Every slot is multiplied, the padded ones too
// (value 0, delta 0): an x holding inf or NaN at a column a padded slot
// reaches gives NaN, as in the reference and the plain versions.
//
// K3/K4 sell_spmv: y[i] = sum over p, in pass order, of vals[p, i] * x[c].
//   Replaces pyamg_tpu/ops/sell_kernels.py:_spmv_call (K3, x resident in
//   VMEM) and :_spmv_tiled_call (K4, x streamed in row tiles past the
//   TPU's 6 MB VMEM budget); Hopper reads x from device memory at any
//   size, so one kernel covers both regimes.
// K5 sell_gs_sweep: one directional hybrid Gauss-Seidel sweep on a square
//   SELL.  Replaces pyamg_tpu/ops/sell_kernels.py:_gs_call.  1024-row
//   tiles are visited in order (or reversed); within a tile every row
//   computes r = b - sum_p vals * x[c], subtracting pass by pass, from the
//   x at tile entry, and then x += (omega * Dinv) * r.
//
// What bounds them on this card.  Each slot costs a 4-byte value, a
// 4-byte delta and a 4-byte x read for 2 flops, so both are bound by
// bytes once enough loads are in flight.  A first design (one thread per
// row, passes in series; K5 one block walking the tiles) was bound by
// latency instead: each batch of passes was a chain of dependent loads,
// a narrow operator (768 rows) ran 3 blocks on 132 SMs, and K5 ran on
// one SM.  The designs below spread each row's passes over many threads
// and keep the summation order of the plain versions, so that kernel and
// plain version agree bit for bit.
//
// K3.  Two forms, picked by ops/sell_kernels.py (spmv_geometry).
//   Direct (a wide, short operator): one thread per row, kDirectSlabs
//   slabs a block, no cluster; the values and deltas of 4 passes are
//   loaded together, then their x, and the products are added in
//   registers in pass order.  Where every slot holding 0 has delta 0 (the
//   plan's padded slots do; the wrapper checks the plan once when it is
//   placed), such a slot's delta is not read: it would be 0.
//   Staged (a narrow or deep one): a cluster of C blocks takes one
//   128-row slab.  Its passes are cut into rounds of C * Q: block r of
//   the cluster takes Q of them, split among its G pass-groups of 128
//   threads (group g takes every G-th).  A thread loads the values and
//   deltas of kBatch passes, then their x, so that 3 * kBatch loads are
//   in flight.  Each product is rounded (__fmul_rn) and staged in shared
//   memory; after a barrier (a cluster barrier when C > 1) the owner of
//   each row adds the round's products in pass order with __fadd_rn.
//   With a cluster, block r owns 128 / C rows of the slab and first
//   gathers their products from every block of the cluster through
//   distributed shared memory (16-byte reads), so that the owner's chain
//   reads local shared memory.  Two stages alternate when there is more
//   than one round.  The 768-row, 839-pass operator of the 64^3 path runs
//   6 clusters of 8 blocks of 8 groups.
// K5.  One cluster of 8 blocks, block r owning sublane r (128 rows) of
//   every tile, with G pass-groups.  The values and deltas of the coming
//   chunks of passes do not depend on x: they stream through a ring of
//   shared-memory stages filled by TMA (one 2-D box of [chunk][128] values
//   and one of deltas per chunk, on an mbarrier), ahead across tiles;
//   one bulk copy per pass row was issue-bound on the card, and values
//   loaded into registers a chunk ahead (to leave room for x in shared
//   memory) were slower: their latency came back at every tile's
//   barriers.  A chunk is a whole tile's passes where two stages of it
//   fit.  Each chunk's products overwrite their values in the stage; the
//   row's owner subtracts them in pass order (__fsub_rn).  Where x fits
//   beside two stages (gs_geometry decides), every block keeps a copy of
//   x in shared memory, and a tile's updates are written into every copy
//   through distributed shared memory; otherwise x stays in device memory
//   and is
//   read with ld.global.cg (L2, coherent across SMs; never the
//   non-coherent path).  Per tile, a split cluster barrier (a relaxed
//   arrive once the block's reads of the tile-entry x are done, the wait
//   after the residual chain) orders the reads before the writes, and a
//   second (release after the writes, acquire before the next tile's
//   reads) publishes them.  As the reference, each launch starts from x
//   padded with zeros to the plan's Sy * 128 rows and sweeps all of them.
//
// C ABI (loaded with ctypes): each entry point checks its geometry,
// raises the kernel's dynamic shared-memory limit as far as the launch
// needs, launches on the given stream (as a cluster where the form has
// one), does not synchronise, allocates nothing, and returns the launch's
// error (cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda.h>             // CUtensorMap (its encoder is looked up at run time)
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLane = 128;
constexpr int kGsTile = 1024;       // 8 sublanes x 128 lanes, as the reference
constexpr int kGsCluster = 8;       // one block per sublane of a tile
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may use
constexpr int kBatch = 8;           // passes whose loads a thread issues together
constexpr int kDirectSlabs = 2;     // 128-row slabs of a one-thread-per-row block
constexpr int kGsBatch = 16;        // passes whose x reads a K5 thread issues together
constexpr int kGsMaxStages = 4;     // stages of K5's ring, at most
constexpr int kChain = 16;          // products a chain loads ahead of its adds

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

// an arrival that publishes no writes: for a barrier that only orders
// reads whose values have already been used before later writes
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// the one arrival of a stage's phase, announcing the bytes its copies bring
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// a TMA copy of the box at (c0, c1) of a 2-D tensor map into shared
// memory, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// r - t[0] - t[1] - ... (kSub) or a + t[0] + t[1] + ... over n products
// at stride, in order, with the loads of kChain products issued ahead of
// their adds
template <bool kSub>
__device__ __forceinline__ float chain_in_order(float a, const float* t,
                                                int n, int stride) {
  int q = 0;
  for (; q + kChain <= n; q += kChain) {
    float u[kChain];
#pragma unroll
    for (int j = 0; j < kChain; ++j) u[j] = t[(q + j) * stride];
#pragma unroll
    for (int j = 0; j < kChain; ++j)
      a = kSub ? __fsub_rn(a, u[j]) : __fadd_rn(a, u[j]);
  }
  for (; q < n; ++q)
    a = kSub ? __fsub_rn(a, t[q * stride]) : __fadd_rn(a, t[q * stride]);
  return a;
}

__device__ __forceinline__ bool in_range(int c, int m) {
  return static_cast<unsigned>(c) < static_cast<unsigned>(m);
}

// ---------------------------------------------------------------------------
// K3/K4
// ---------------------------------------------------------------------------

// kDirect: one thread per row (groups == cluster == 1), summing in
// registers in pass order, kDirectSlabs slabs to a block, launched without
// a cluster, small enough for 2048 threads on an SM
template <bool kDirect>
__global__ void __launch_bounds__(kDirect ? kDirectSlabs * kLane : 1024,
                                  kDirect ? 2048 / (kDirectSlabs * kLane) : 1)
sell_spmv_kernel(const float* __restrict__ vals, const int* __restrict__ delta,
                 const int* __restrict__ bases, int T, long long S, int n,
                 int m, int t, int fat, int zero_delta0, const float* x,
                 float* __restrict__ y, int groups, int cluster, int chunk,
                 int rounds, int buffers) {
  // [buffers][chunk][128] products; with a cluster, then [cluster * chunk]
  // [owned] products of this block's rows gathered from the whole cluster
  extern __shared__ __align__(16) float prod[];
  constexpr int kB = kDirect ? 4 : kBatch;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = kDirect ? 0 : static_cast<int>(cl.block_rank());
  const int slab = kDirect ? blockIdx.x * kDirectSlabs + threadIdx.x / kLane
                           : blockIdx.x / cluster;
  const int lane = threadIdx.x % kLane;
  const int group = kDirect ? 0 : threadIdx.x / kLane;
  const long long row = static_cast<long long>(slab) * kLane + lane;
  if (kDirect && row >= S) return;
  const int col0 = kLane * (fat ? slab * t : slab / t);
  const int owned = kLane / cluster;          // rows this block sums
  const bool owner = kDirect || threadIdx.x < owned;
  float* gath = prod + buffers * chunk * kLane;
  float acc = -0.f;                           // -0 + a == a for every a

  for (int k = 0; k < rounds; ++k) {
    float* buf = prod + (k % buffers) * chunk * kLane;
    const int p0 = (k * cluster + rank) * chunk;
    for (int q = group; q < chunk; q += groups * kB) {
      float v[kB], xv[kB];
      int c[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int qq = q + u * groups, p = p0 + qq;
        const bool in = qq < chunk && p < T;
        const long long off = static_cast<long long>(in ? p : 0) * S + row;
        v[u] = __ldg(vals + off);
        // where every slot holding 0 has delta 0, such a slot's delta is
        // not read
        const int d = zero_delta0 && v[u] == 0.f ? 0 : __ldg(delta + off);
        c[u] = in ? col0 + kLane * __ldg(bases + p) + d : -1;
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) xv[u] = in_range(c[u], m) ? x[c[u]] : 0.f;
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int qq = q + u * groups;
        if (qq >= chunk || p0 + qq >= T) continue;
        if (kDirect) acc = __fadd_rn(acc, __fmul_rn(v[u], xv[u]));
        else buf[qq * kLane + lane] = __fmul_rn(v[u], xv[u]);
      }
    }
    if (kDirect) continue;
    // the round's products of this block's rows, in pass order: [j][stride]
    const float* mine = buf;
    int stride = kLane;
    if (cluster == 1) {
      __syncthreads();
    } else {
      cluster_sync();               // every block's products of round k staged
      const int quads = owned / 4;
      for (int j = threadIdx.x; j < cluster * chunk * quads; j += blockDim.x) {
        const int rr = j / (chunk * quads), rem = j % (chunk * quads);
        const int q = rem / quads, f = rem % quads;
        const float4* src = reinterpret_cast<const float4*>(
            cl.map_shared_rank(buf, rr) + q * kLane + rank * owned);
        reinterpret_cast<float4*>(gath + (rr * chunk + q) * owned)[f] = src[f];
      }
      __syncthreads();
      mine = gath;
      stride = owned;
    }
    if (owner)
      acc = chain_in_order<false>(acc, mine + threadIdx.x,
                         min(cluster * chunk, T - k * cluster * chunk), stride);
  }
  const long long i = kDirect ? row
                              : static_cast<long long>(slab) * kLane +
                                    rank * owned + threadIdx.x;
  if (owner && i < n) y[i] = acc;
  if (cluster > 1) cluster_sync();  // no block leaves while its stage is read
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

template <bool kXShared>
__global__ void __launch_bounds__(1024)
sell_gs_kernel(const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap dmap,
               const int* __restrict__ bases, int T, int n,
               const float* __restrict__ b, const float* __restrict__ dinv,
               float omega, int reverse, float* x, int tiles, int groups,
               int chunk, int stages) {
  // x holds tiles * 1024 rows: the plan's padded rows; b and Dinv hold n
  extern __shared__ __align__(128) float smem[];
  __shared__ unsigned long long full[kGsMaxStages];   // one per stage
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());   // sublane
  const int lane = threadIdx.x % kLane;
  const int group = threadIdx.x / kLane;
  const bool owner = group == 0;
  const bool producer = threadIdx.x / 32 == blockDim.x / 32 - 1;  // last warp
  const int per = chunk / groups;           // passes of a chunk per thread
  const int rows = tiles * kGsTile;         // the plan's padded rows
  float* xs = smem;                         // [rows] when kXShared
  float* ring = smem + (kXShared ? rows : 0);   // stages x {[chunk][128] vals,
  const int stage_floats = 2 * chunk * kLane;   //  [chunk][128] deltas}
  int* sbases = reinterpret_cast<int*>(ring + stages * stage_floats);  // [T]
  const int cpt = (T + chunk - 1) / chunk;  // chunks per tile
  const int steps = tiles * cpt;
  auto tile_of = [&](int k) { return reverse ? tiles - 1 - k : k; };

  // chunk s: one TMA box of [chunk][128] values and one of deltas (this
  // block's sublane of the tile, passes past T read as 0), issued by the
  // producer warp's first thread
  auto issue = [&](int s) {
    if (!producer || threadIdx.x % 32 != 0 || s >= steps) return;
    const int p0 = (s % cpt) * chunk;
    const int row0 = tile_of(s / cpt) * kGsTile + rank * kLane;
    float* st = ring + (s % stages) * stage_floats;
    unsigned long long* bar = &full[s % stages];
    mbar_expect(bar, 2u * chunk * kLane * 4);
    tma_load(st, &vmap, row0, p0, bar);
    tma_load(st + chunk * kLane, &dmap, row0, p0, bar);
  };

  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) mbar_init(&full[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < stages - 1; ++s) issue(s);
  for (int p = threadIdx.x; p < T; p += blockDim.x) sbases[p] = bases[p];
  __syncthreads();        // the bases are staged
  // each direction starts from x padded with zeros, as the reference
  if (kXShared) {
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
      xs[i] = i < n ? x[i] : 0.f;
  } else {
    for (int i = n + rank * blockDim.x + threadIdx.x; i < rows;
         i += kGsCluster * blockDim.x)
      x[i] = 0.f;
  }
  cluster_arrive();       // the padded rows are zero in every block's view
  bool published = true;  // a cluster barrier is open: wait before reading x

  // b and Dinv of a row are loaded one tile ahead, off the critical path
  const int i0 = tile_of(0) * kGsTile + rank * kLane + lane;
  float r = 0.f, di = 0.f;
  float b_next = owner && i0 < n ? b[i0] : 0.f;
  float d_next = owner && i0 < n ? dinv[i0] : 0.f;
  for (int s = 0; s < steps; ++s) {
    const int k = s / cpt, ch = s % cpt;
    const int col0 = tile_of(k) * kGsTile + rank * kLane;   // 128 * sublane
    const int i = col0 + lane;
    if (ch == 0 && owner) {
      r = b_next;
      di = d_next;
      const int inext =
          k + 1 < tiles ? tile_of(k + 1) * kGsTile + rank * kLane + lane : n;
      b_next = inext < n ? b[inext] : 0.f;
      d_next = inext < n ? dinv[inext] : 0.f;
    }
    mbar_wait(&full[s % stages], (s / stages) & 1);   // chunk s has landed
    if (published) {
      cluster_wait();     // the previous tile's updates are visible
      published = false;
    }
    float* st = ring + (s % stages) * stage_floats;
    const int* sd = reinterpret_cast<const int*>(st + chunk * kLane);
    const int p0 = ch * chunk, cnt = min(chunk, T - p0);
    // all of a thread's x reads of the chunk in flight together (per is
    // at most kGsBatch for a plan of up to 128 passes)
    for (int u0 = 0; u0 < per; u0 += kGsBatch) {
      float xv[kGsBatch];
      int c[kGsBatch];
#pragma unroll
      for (int u = 0; u < kGsBatch; ++u) {
        const int q = group * per + u0 + u;
        const bool in = u0 + u < per && q < cnt;
        c[u] = in ? col0 + kLane * sbases[p0 + q] + sd[q * kLane + lane] : -1;
      }
#pragma unroll
      for (int u = 0; u < kGsBatch; ++u) {
        if (!in_range(c[u], rows)) xv[u] = 0.f;
        else if (kXShared) xv[u] = xs[c[u]];
        else xv[u] = __ldcg(x + c[u]);
      }
#pragma unroll
      for (int u = 0; u < kGsBatch; ++u) {
        const int q = group * per + u0 + u;
        if (u0 + u < per && q < cnt)
          st[q * kLane + lane] = __fmul_rn(st[q * kLane + lane], xv[u]);
      }
    }
    __syncthreads();      // the chunk's products are staged, and chunk
                          // s - 1 is consumed: its stage may refill
    if (producer) {       // (not an owner: this overlaps the residual chain)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(s + stages - 1);
    }
    const bool last = ch == cpt - 1;
    if (last) cluster_arrive_relaxed();   // done with the tile-entry x
    if (owner) r = chain_in_order<true>(r, st + lane, cnt, kLane);
    if (last) {
      float xnew = 0.f;
      if (owner) {
        const float xold = kXShared ? xs[i] : __ldcg(x + i);
        xnew = __fadd_rn(xold, __fmul_rn(__fmul_rn(omega, di), r));
      }
      cluster_wait();     // every block is done with the tile-entry x
      if (owner) {
        if (kXShared) {
          for (int rr = 0; rr < kGsCluster; ++rr)
            cl.map_shared_rank(xs, rr)[i] = xnew;
        } else {
          x[i] = xnew;
        }
      }
      cluster_arrive();   // publish the tile's updates
      published = true;
    }
  }
  if (published) cluster_wait();
  if (kXShared) {         // every copy now holds the swept x
    for (int i = rank * blockDim.x + threadIdx.x; i < n;
         i += kGsCluster * blockDim.x)
      x[i] = xs[i];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *allowed = bytes;
  return e;
}

cudaLaunchConfig_t cluster_config(int blocks, int threads, int smem,
                                  int cluster, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kXShared>
int launch_gs(const CUtensorMap& vmap, const CUtensorMap& dmap,
              const int* bases, int T, int n, const float* b, const float* dinv,
              float omega, int reverse, float* x, int tiles, int groups,
              int chunk, int stages, int smem, void* stream) {
  static int allowed = 48 * 1024;
  auto kernel = sell_gs_kernel<kXShared>;
  cudaError_t e = allow_smem(kernel, smem, &allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      kGsCluster, groups * kLane, smem, kGsCluster, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, vmap, dmap, bases, T, n, b, dinv,
                         omega, reverse, x, tiles, groups, chunk, stages);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

bool pow2_upto8(int v) { return v == 1 || v == 2 || v == 4 || v == 8; }

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// a (T, S) plan array as a 2-D tensor map with [rows][128] boxes
bool tensor_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                long long S, int T, int rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(T)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(S) * 4};
  const cuuint32_t box[2] = {kLane, static_cast<cuuint32_t>(rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

int pyamg_sell_spmv_f32(const float* vals, const int* delta, const int* bases,
                        int T, long long S, int n, int m, int t, int fat,
                        int zero_delta0, const float* x, float* y, int slabs,
                        int groups, int cluster, int chunk, int rounds,
                        int buffers, int smem, void* stream) {
  if (n <= 0) return 0;
  if (!pow2_upto8(groups) || !pow2_upto8(cluster) || chunk < 1 ||
      rounds < 1 || (long long)rounds * cluster * chunk < T ||
      (buffers != 1 && buffers != 2) || (rounds > 1 && buffers != 2) ||
      (long long)slabs * kLane < n || (long long)slabs * kLane > S ||
      smem > kMaxSmem ||
      (groups * cluster > 1 &&
       smem < (buffers + (cluster > 1)) * chunk * kLane * 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool direct = groups == 1 && cluster == 1;
  static int allowed = 48 * 1024;
  cudaError_t e = direct ? cudaSuccess
                         : allow_smem(sell_spmv_kernel<false>, smem, &allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(
      slabs * cluster, groups * kLane, smem, cluster, stream, &attr);
  if (direct) {         // whole slabs per block, no cluster
    cfg.gridDim = dim3((slabs + kDirectSlabs - 1) / kDirectSlabs);
    cfg.blockDim = dim3(kDirectSlabs * kLane);
    cfg.numAttrs = 0;
  }
  e = cudaLaunchKernelEx(&cfg, direct ? sell_spmv_kernel<true>
                                      : sell_spmv_kernel<false>,
                         vals, delta, bases, T, S, n, m, t, fat, zero_delta0,
                         x, y, groups, cluster, chunk, rounds, buffers);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

int pyamg_sell_gs_sweep_f32(const float* vals, const int* delta,
                            const int* bases, int T, long long S, int n,
                            const float* b, const float* dinv, float omega,
                            int reverse, float* x, int tiles, int groups,
                            int chunk, int stages, int x_shared, int smem,
                            void* stream) {
  if (n <= 0) return 0;
  const long long need = (x_shared ? (long long)tiles * kGsTile * 4 : 0) +
                         (long long)stages * chunk * kLane * 8 + T * 4LL;
  if (!pow2_upto8(groups) || chunk < groups || chunk % groups != 0 ||
      chunk > 256 || stages < 2 || stages > kGsMaxStages ||
      (long long)tiles * kGsTile != S || n > S ||
      smem < need || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap vmap, dmap;
  if (!tensor_map(&vmap, vals, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, S, T, chunk) ||
      !tensor_map(&dmap, delta, CU_TENSOR_MAP_DATA_TYPE_INT32, S, T, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  return x_shared ? launch_gs<true>(vmap, dmap, bases, T, n, b, dinv, omega,
                                    reverse, x, tiles, groups, chunk, stages,
                                    smem, stream)
                  : launch_gs<false>(vmap, dmap, bases, T, n, b, dinv, omega,
                                     reverse, x, tiles, groups, chunk, stages,
                                     smem, stream);
}

}  // extern "C"
