// Factorization kernels of the batched MPC solve at the 128 tile, the
// Newton-Schulz products on the tensor cores.
//
// ns_inverse_scaled_kernel replaces the TPU kernel
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_scaled (_kernel_scaled_il)
// ns_inverse_scaled_build_kernel replaces
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_scaled_build (_kernel_scaled_build_il)
// ns_inverse_warm_kernel replaces
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_warm (_kernel_warm)
// qct_ns_inverse_plain launches ns_inverse_scaled_kernel in place of
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_blocked
//   (_kernel_blocked), npad 128 (ns_plain.cu has ns_inverse_pallas)
//
// (ns_refine.cu has the warm refinement ns_inverse_pallas_refine, K6.)
//
// All run the NS core of ns_core.cuh, one 256-thread block per system. The
// layout: K, X and T are 128 x 128 fp32 tiles in shared memory, unpadded,
// columns XOR-swizzled by 8 (row % 4) (load_tile / store_tile move a tile
// between its row-major global form and that layout a float4 a thread), and
// a ring of two 16-row chunks holds B of a bf16x3 product as bf16 hi/lo
// planes: 212,992 bytes, one block per SM. The product: 8 warps of 32 x 64
// tiles in the mma accumulator layout, bf16x3 as three mma.sync m16n8k16
// bf16 passes, the fp32 tail as 3xTF32 m16n8k8 passes with one fp32 add per
// 16 k. K2 builds, scales and writes ks straight into the swizzled K tile;
// K7 forms its guard from the guard product's accumulators, row sums over
// the mma layout reduced across the block, so its branch is uniform and its
// cold branch is ns_schedule itself. What bounds them, on an NVIDIA H100
// 80GB HBM3 at 700 W: the work around the mmas (operand splits and shared
// memory loads on the CUDA cores, 2 warps a scheduler), which makes a bf16x3
// product ~2x its mma time (ns_core.cuh; PERF.md, section 6). The TPU
// kernels' G = 8 grouping came from the TPU grid; here any batch size works.
#include <cstdint>

#include "ns_core.cuh"

namespace qct {

// src (128 x 128, row-major, global) -> the swizzled tile dst, a float4 a thread.
__device__ __forceinline__ void load_tile(const float* __restrict__ src, float* dst) {
  for (int idx = threadIdx.x; idx < NS_TILE / 4; idx += NS_THREADS) {
    const int r = idx / (NS_N / 4), c = 4 * (idx % (NS_N / 4));
    *reinterpret_cast<float4*>(dst + sw<NS_N>(r, c)) = reinterpret_cast<const float4*>(src)[idx];
  }
}

__device__ __forceinline__ void store_tile(const float* src, float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < NS_TILE / 4; idx += NS_THREADS) {
    const int r = idx / (NS_N / 4), c = 4 * (idx % (NS_N / 4));
    reinterpret_cast<float4*>(dst)[idx] = *reinterpret_cast<const float4*>(src + sw<NS_N>(r, c));
  }
}

// ks (B, 128, 128) Jacobi-scaled, identity on the pad -> inv (B, 128, 128).
__global__ void __launch_bounds__(NS_THREADS)
ns_inverse_scaled_kernel(const float* __restrict__ ks, float* __restrict__ inv, NsSchedule s) {
  extern __shared__ __align__(16) float smem[];
  const NsTiles m(smem);
  const size_t base = static_cast<size_t>(blockIdx.x) * NS_TILE;
  load_tile(ks + base, m.K);
  __syncthreads();
  ns_schedule(m.K, m.X, m.T, m.S, s);
  store_tile(m.X, inv + base);
}

// K = hp + blockdiag3(g9), d = rsqrt(max(diag K, 1e-30)), ks = D K D, then the
// schedule on ks. hp (B, 128, 128) is hess_n + sigma I with identity on the
// pad; g9 (B, 9, nblk) holds the 3x3 gram blocks component-major, entry
// (3*(r%3) + c%3, r/3) lands on K[r][c] when r/3 == c/3 < nblk. Writes
// inv and ks (B, 128, 128) and d_row (B, 128).
__global__ void __launch_bounds__(NS_THREADS)
ns_inverse_scaled_build_kernel(const float* __restrict__ hp, const float* __restrict__ g9,
                               int nblk, float* __restrict__ inv, float* __restrict__ ks_out,
                               float* __restrict__ d_row, NsSchedule s) {
  extern __shared__ __align__(16) float smem[];
  const NsTiles m(smem);
  __shared__ float d[NS_N];
  const size_t base = static_cast<size_t>(blockIdx.x) * NS_TILE;
  const float* g = g9 + static_cast<size_t>(blockIdx.x) * 9 * nblk;
  for (int idx = threadIdx.x; idx < NS_TILE; idx += NS_THREADS) {
    const int r = idx / NS_N, c = idx % NS_N;
    float v = hp[base + idx];
    const int blk = c / 3;
    if (r / 3 == blk && blk < nblk) v += g[(3 * (r % 3) + c % 3) * nblk + blk];
    m.K[sw<NS_N>(r, c)] = v;
  }
  __syncthreads();
  if (threadIdx.x < NS_N) {
    const int i = threadIdx.x;
    const float di = 1.f / sqrtf(fmaxf(m.K[sw<NS_N>(i, i)], 1e-30f));
    d[i] = di;
    d_row[static_cast<size_t>(blockIdx.x) * NS_N + i] = di;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NS_TILE; idx += NS_THREADS) {
    const int r = idx / NS_N, c = idx % NS_N;
    const float v = m.K[sw<NS_N>(r, c)] * d[r] * d[c];
    m.K[sw<NS_N>(r, c)] = v;
    ks_out[base + idx] = v;
  }
  __syncthreads();
  ns_schedule(m.K, m.X, m.T, m.S, s);
  store_tile(m.X, inv + base);
}

// Guarded warm NS: X0 = init (B, 128, 128), in the Jacobi scaling of ks. The
// block forms T = 2I - K X0 with a bf16x3 product and the guard
// r0 = max_i sum_j |I - K X0|_ij from the same product, its row sums taken
// over the mma layout and reduced block-wide as ns_schedule reduces alpha.
// r0 is one value per block, so the branch is uniform and only one side
// runs: below the guard, the first warm step completes from that T (X = X T,
// the K X0 product reused) and n_wquad - 1 bf16x3 and n_whi fp32 quadratic
// steps follow; otherwise (a NaN row sum counts as infinite) ns_schedule
// runs on K, K3's own code, so a tripped guard returns K3's result.
__global__ void __launch_bounds__(NS_THREADS)
ns_inverse_warm_kernel(const float* __restrict__ ks, const float* __restrict__ init,
                       float* __restrict__ inv, NsSchedule s, int n_wquad, int n_whi,
                       float guard) {
  extern __shared__ __align__(16) float smem[];
  const NsTiles m(smem);
  __shared__ float warp_max[WARPS];
  const NsLane ln;
  const size_t base = static_cast<size_t>(blockIdx.x) * NS_TILE;
  load_tile(ks + base, m.K);
  load_tile(init + base, m.X);
  __syncthreads();
  Acc acc;
  mm_tile<true>(m.K, m.X, m.S, acc);
  store_t<NS_N>(m.T, acc, 1.f, 0);
  // row sums of |I - acc|: this thread's 4 rows over its 16 columns, then the
  // 4 lanes of a row (xor 1, 2), then the 2 warps of a row through the
  // staging ring, which the product no longer reads after this barrier
  float part[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = ln.row(mt, h);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sum += fabsf((i == ln.col(nt) + e ? 1.f : 0.f) - acc[mt][nt][2 * h + e]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      part[mt][h] = sum;
    }
  __syncthreads();  // also: T complete, every read of X done
  float* rows = reinterpret_cast<float*>(m.S);  // [2 warp columns][128 rows]
  if (ln.t == 0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) rows[ln.wn * NS_N + ln.row(mt, h)] = part[mt][h];
  }
  __syncthreads();
  float row = 0.f;
  if (threadIdx.x < NS_N) {
    row = rows[threadIdx.x] + rows[NS_N + threadIdx.x];
    if (isnan(row)) row = INFINITY;  // fmaxf drops NaN: a NaN start fails
  }
  const float r0 = cta_max(row, warp_max);  // its barriers end every read of rows
  if (r0 < guard) {
    mm_tile<true>(m.X, m.T, m.S, acc);
    __syncthreads();
    store_x<NS_N>(m.X, acc, 1.f);
    __syncthreads();
    for (int it = 1; it < n_wquad; ++it) ns_step<true>(m.K, m.X, m.T, m.S, 1.f);
    for (int it = 0; it < n_whi; ++it) ns_step<false>(m.K, m.X, m.T, m.S, 1.f);
  } else {
    ns_schedule(m.K, m.X, m.T, m.S, s);
  }
  store_tile(m.X, inv + base);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(NS_SMEM_BYTES));
}

}  // namespace qct

// C entry points (loaded with ctypes). Each returns the launch's cudaError_t;
// the caller checks bounds, types and the schedule length.
extern "C" int qct_ns_inverse_scaled(const float* ks, float* inv, int b, const float* mus,
                                     int n_scaled, int n_quad, int n_hi, void* stream) {
  if (n_scaled > qct::NS_MAX_MUS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = qct::allow_smem(qct::ns_inverse_scaled_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_scaled_kernel<<<b, qct::NS_THREADS, qct::NS_SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream)>>>(
      ks, inv, qct::make_schedule(mus, n_scaled, n_quad, n_hi));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qct_ns_inverse_scaled_build(const float* hp, const float* g9, int nblk,
                                           float* inv, float* ks, float* d_row, int b,
                                           const float* mus, int n_scaled, int n_quad,
                                           int n_hi, void* stream) {
  if (n_scaled > qct::NS_MAX_MUS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = qct::allow_smem(qct::ns_inverse_scaled_build_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_scaled_build_kernel<<<b, qct::NS_THREADS, qct::NS_SMEM_BYTES,
                                        static_cast<cudaStream_t>(stream)>>>(
      hp, g9, nblk, inv, ks, d_row, qct::make_schedule(mus, n_scaled, n_quad, n_hi));
  return static_cast<int>(cudaGetLastError());
}

// Plain fp32 NS on a batch at the 128 tile (the TPU kernel
// ns_inverse_pallas_blocked): X0 = I / ||K||_inf and `iters` fp32 steps, K3's
// kernel on a schedule of n_hi = iters fp32 steps alone. One system (K8) and
// the 256 tile run ns_plain.cu.
extern "C" int qct_ns_inverse_plain(const float* ks, float* inv, int b, int iters, void* stream) {
  cudaError_t err = qct::allow_smem(qct::ns_inverse_scaled_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_scaled_kernel<<<b, qct::NS_THREADS, qct::NS_SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream)>>>(
      ks, inv, qct::make_schedule(nullptr, 0, 0, iters));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qct_ns_inverse_warm(const float* ks, const float* init, float* inv, int b,
                                   const float* mus, int n_scaled, int n_quad, int n_hi,
                                   int n_wquad, int n_whi, float guard, void* stream) {
  if (n_scaled > qct::NS_MAX_MUS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = qct::allow_smem(qct::ns_inverse_warm_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_warm_kernel<<<b, qct::NS_THREADS, qct::NS_SMEM_BYTES,
                                static_cast<cudaStream_t>(stream)>>>(
      ks, init, inv, qct::make_schedule(mus, n_scaled, n_quad, n_hi), n_wquad, n_whi, guard);
  return static_cast<int>(cudaGetLastError());
}
