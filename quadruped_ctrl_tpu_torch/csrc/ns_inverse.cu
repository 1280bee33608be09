// Factorization kernels of the batched MPC solve, one block per system.
//
// ns_inverse_scaled_kernel replaces the TPU kernel
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_scaled (_kernel_scaled_il)
// ns_inverse_scaled_build_kernel replaces
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_scaled_build (_kernel_scaled_build_il)
// ns_inverse_refine_kernel replaces
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_refine (_kernel_refine)
// ns_inverse_warm_kernel replaces
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_warm (_kernel_warm)
// qct_ns_inverse_plain launches ns_inverse_scaled_kernel in place of
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas (_kernel) and
//   ns_inverse_pallas_blocked (_kernel_blocked)
//
// All run the shared NS core (ns_core.cuh) at the 128 tile. The TPU kernels'
// G = 8 grouping came from the TPU grid; here any batch size works. What bounds
// them and what the design does about it: see ns_core.cuh.
#include <cstdint>

#include "ns_core.cuh"

namespace qct {

__device__ __forceinline__ void load_tile(const float* __restrict__ src, float* dst) {
  for (int idx = threadIdx.x; idx < NS_N * NS_N; idx += NS_THREADS) {
    dst[(idx / NS_N) * NS_LD + idx % NS_N] = src[idx];
  }
}

__device__ __forceinline__ void store_tile(const float* src, float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < NS_N * NS_N; idx += NS_THREADS) {
    dst[idx] = src[(idx / NS_N) * NS_LD + idx % NS_N];
  }
}

// ks (B, 128, 128) Jacobi-scaled, identity on the pad -> inv (B, 128, 128).
__global__ void __launch_bounds__(NS_THREADS)
ns_inverse_scaled_kernel(const float* __restrict__ ks, float* __restrict__ inv, NsSchedule s) {
  extern __shared__ float smem[];
  float* K = smem;
  float* X = K + NS_N * NS_LD;
  float* T = X + NS_N * NS_LD;
  const size_t base = static_cast<size_t>(blockIdx.x) * NS_N * NS_N;
  load_tile(ks + base, K);
  __syncthreads();
  ns_schedule(K, X, T, s);
  store_tile(X, inv + base);
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
  extern __shared__ float smem[];
  float* K = smem;
  float* X = K + NS_N * NS_LD;
  float* T = X + NS_N * NS_LD;
  __shared__ float d[NS_N];
  const size_t base = static_cast<size_t>(blockIdx.x) * NS_N * NS_N;
  const float* g = g9 + static_cast<size_t>(blockIdx.x) * 9 * nblk;
  for (int idx = threadIdx.x; idx < NS_N * NS_N; idx += NS_THREADS) {
    const int r = idx / NS_N, c = idx % NS_N;
    float v = hp[base + idx];
    const int blk = c / 3;
    if (r / 3 == blk && blk < nblk) v += g[(3 * (r % 3) + c % 3) * nblk + blk];
    K[r * NS_LD + c] = v;
  }
  __syncthreads();
  if (threadIdx.x < NS_N) {
    const int i = threadIdx.x;
    const float di = 1.f / sqrtf(fmaxf(K[i * NS_LD + i], 1e-30f));
    d[i] = di;
    d_row[static_cast<size_t>(blockIdx.x) * NS_N + i] = di;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NS_N * NS_N; idx += NS_THREADS) {
    const int r = idx / NS_N, c = idx % NS_N;
    const float v = K[r * NS_LD + c] * d[r] * d[c];
    K[r * NS_LD + c] = v;
    ks_out[base + idx] = v;
  }
  __syncthreads();
  ns_schedule(K, X, T, s);
  store_tile(X, inv + base);
}

// Guard-free warm NS: X starts from init (B, 128, 128), in the Jacobi scaling
// of ks, instead of alpha I, and runs n_quad bf16x3 and n_hi fp32 quadratic
// steps with no scaled phase: K3's steps on another start. The caller
// guarantees ||I - ks init|| < 1 (each step squares it).
__global__ void __launch_bounds__(NS_THREADS)
ns_inverse_refine_kernel(const float* __restrict__ ks, const float* __restrict__ init,
                         float* __restrict__ inv, int n_quad, int n_hi) {
  extern __shared__ float smem[];
  float* K = smem;
  float* X = K + NS_N * NS_LD;
  float* T = X + NS_N * NS_LD;
  const size_t base = static_cast<size_t>(blockIdx.x) * NS_N * NS_N;
  load_tile(ks + base, K);
  load_tile(init + base, X);
  __syncthreads();
  for (int it = 0; it < n_quad; ++it) ns_step<true>(K, X, T, 1.f);
  for (int it = 0; it < n_hi; ++it) ns_step<false>(K, X, T, 1.f);
  store_tile(X, inv + base);
}

// Guarded warm NS: X0 = init (B, 128, 128), in the Jacobi scaling of ks. The
// block forms T = 2I - K X0 with a bf16x3 product and the guard
// r0 = max_i sum_j |I - K X0|_ij from the same product, reduced block-wide as
// ns_schedule reduces alpha. r0 is one value per block, so the branch is
// uniform and only one side runs: below the guard, the first warm step
// completes from that T (X = X T, the K X0 product reused) and n_wquad - 1
// bf16x3 and n_whi fp32 quadratic steps follow; otherwise (a NaN row sum
// counts as infinite) ns_schedule runs on K, K3's own code, so a tripped guard
// returns K3's result.
__global__ void __launch_bounds__(NS_THREADS)
ns_inverse_warm_kernel(const float* __restrict__ ks, const float* __restrict__ init,
                       float* __restrict__ inv, NsSchedule s, int n_wquad, int n_whi,
                       float guard) {
  extern __shared__ float smem[];
  float* K = smem;
  float* X = K + NS_N * NS_LD;
  float* T = X + NS_N * NS_LD;
  __shared__ float warp_max[NS_THREADS / 32];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t base = static_cast<size_t>(blockIdx.x) * NS_N * NS_N;
  load_tile(ks + base, K);
  load_tile(init + base, X);
  __syncthreads();
  float acc[8][8];
  mm_tile<true>(K, X, acc);
  float rmax = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
    float row = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = tx + 16 * c;
      row += fabsf((i == j ? 1.f : 0.f) - acc[r][c]);
      T[i * NS_LD + j] = (i == j ? 2.f : 0.f) - acc[r][c];
    }
    // row i's 128 entries lie on the 16 threads of this ty (lanes differing in bits 0-3)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) row += __shfl_xor_sync(0xffffffffu, row, off);
    rmax = fmaxf(rmax, isnan(row) ? INFINITY : row);  // fmaxf drops NaN: a NaN start fails
  }
  rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 16));  // the warp's other ty
  if ((tid & 31) == 0) warp_max[tid >> 5] = rmax;
  __syncthreads();  // also: T complete, every read of X done
  float r0 = warp_max[0];
#pragma unroll
  for (int w = 1; w < NS_THREADS / 32; ++w) r0 = fmaxf(r0, warp_max[w]);
  if (r0 < guard) {
    mm_tile<true>(X, T, acc);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) X[(ty + 16 * r) * NS_LD + tx + 16 * c] = acc[r][c];
    __syncthreads();
    for (int it = 1; it < n_wquad; ++it) ns_step<true>(K, X, T, 1.f);
    for (int it = 0; it < n_whi; ++it) ns_step<false>(K, X, T, 1.f);
  } else {
    ns_schedule(K, X, T, s);
  }
  store_tile(X, inv + base);
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

extern "C" int qct_ns_inverse_refine(const float* ks, const float* init, float* inv, int b,
                                     int n_quad, int n_hi, void* stream) {
  cudaError_t err = qct::allow_smem(qct::ns_inverse_refine_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_refine_kernel<<<b, qct::NS_THREADS, qct::NS_SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream)>>>(ks, init, inv, n_quad,
                                                                       n_hi);
  return static_cast<int>(cudaGetLastError());
}

// Plain fp32 NS (the TPU kernels ns_inverse_pallas and ns_inverse_pallas_blocked):
// X0 = I / ||K||_inf and `iters` fp32 steps, K3's kernel on a schedule of
// n_hi = iters fp32 steps alone. One system (b = 1) is the single-instance
// kernel.
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
