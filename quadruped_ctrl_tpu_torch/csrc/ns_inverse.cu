// Factorization kernels of the batched MPC solve at the 128 tile, the
// Newton-Schulz products on the tensor cores.
//
// ns_inverse_scaled_kernel<false> replaces the TPU kernel
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_scaled (_kernel_scaled_il)
// ns_inverse_scaled_build_kernel replaces
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_scaled_build (_kernel_scaled_build_il)
// ns_inverse_scaled_kernel<true> is the cold branch of the guarded warm NS
//   (quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_warm, _kernel_warm's
//   _cold region): the same kernel on the systems whose guard tripped
//
// (ns_refine.cu has the warm refinement K6, the guard and warm branch of K7,
// and K9 at this tile; ns_plain.cu K8 and K9 at 256.)
//
// Both run the NS core of ns_core.cuh, one 256-thread block per system. The
// layout: K, X and T are 128 x 128 fp32 tiles in shared memory, unpadded,
// columns XOR-swizzled by 8 (row % 4) (load_tile / store_tile move a tile
// between its row-major global form and that layout a float4 a thread), and
// a ring of two 16-row chunks holds B of a bf16x3 product as bf16 hi/lo
// planes: 212,992 bytes, one block per SM. The product: 8 warps of 32 x 64
// tiles in the mma accumulator layout, bf16x3 as three mma.sync m16n8k16
// bf16 passes, the fp32 tail as 3xTF32 m16n8k8 passes with one fp32 add per
// 16 k. K2 builds, scales and writes ks straight into the swizzled K tile.
// What bounds them, on an NVIDIA H100
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
// kMasked: only the systems whose flag in `tripped` is not 0 (ns_refine.cu's
// guard sets them); a block whose flag is 0 returns at once and stores
// nothing. Otherwise `tripped` is not read.
template <bool kMasked>
__global__ void __launch_bounds__(NS_THREADS)
ns_inverse_scaled_kernel(const float* __restrict__ ks, float* __restrict__ inv, NsSchedule s,
                         const int* __restrict__ tripped) {
  if (kMasked && tripped[blockIdx.x] == 0) return;
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
  cudaError_t err = qct::allow_smem(qct::ns_inverse_scaled_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_scaled_kernel<false><<<b, qct::NS_THREADS, qct::NS_SMEM_BYTES,
                                         static_cast<cudaStream_t>(stream)>>>(
      ks, inv, qct::make_schedule(mus, n_scaled, n_quad, n_hi), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K3 on the systems of ks whose flag in tripped (b int32) is not 0: the
// cold branch of the guarded warm NS (ns_refine.cu: qct_ns_inverse_warm).
extern "C" int qct_ns_inverse_scaled_masked(const float* ks, float* inv, const int* tripped, int b,
                                            const float* mus, int n_scaled, int n_quad, int n_hi,
                                            void* stream) {
  if (n_scaled > qct::NS_MAX_MUS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = qct::allow_smem(qct::ns_inverse_scaled_kernel<true>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_scaled_kernel<true><<<b, qct::NS_THREADS, qct::NS_SMEM_BYTES,
                                        static_cast<cudaStream_t>(stream)>>>(
      ks, inv, qct::make_schedule(mus, n_scaled, n_quad, n_hi), tripped);
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
