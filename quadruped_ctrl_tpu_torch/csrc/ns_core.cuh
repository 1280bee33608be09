// Newton-Schulz core shared by the two factorization kernels
// (ns_inverse.cu: ns_inverse_scaled_kernel and ns_inverse_scaled_build_kernel).
//
// One thread block owns one Jacobi-scaled SPD system at the 128 tile and keeps
// K, the iterate X and one scratch tile T resident in shared memory for the
// whole schedule, the role VMEM plays for the TPU kernels
// (quadruped_ctrl_tpu/ops/ns_inverse.py: _kernel_scaled_il,
// _kernel_scaled_build_il). The schedule is the TPU one, step for step:
//
//   X0 = I / max_i sum_j |K_ij|
//   scaled    (bf16x3):  X <- mu X (2I - mu K X)   for mu in mu_schedule(a0, n)
//   quadratic (bf16x3):  X <- X (2I - K X)         n_quad times
//   tail      (fp32):    X <- X (2I - K X)         n_hi times
//
// A bf16x3 product splits both operands into bf16 hi/lo parts and sums
// hi*hi + hi*lo + lo*hi with fp32 accumulation (~1e-6 relative). A single
// bf16 or TF32 pass is never used: NS diverges once cond x rounding error
// exceeds 1 (ns_inverse.py, the mixed-precision block comment).
//
// What bounds it on an H100: every product is 128^3 fp32 FMAs per operand pair
// issued from the CUDA cores out of shared memory (3 per bf16x3 product), so
// the kernel is FMA-issue bound at 1 block (198 KB of shared memory) per SM.
// The operands are split on the fly as they are read; each thread holds an
// 8 x 8 grid of outputs in registers. Moving the bf16x3 products onto the
// tensor cores (mma / wgmma on the pre-split hi/lo operands) is the next step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace qct {

constexpr int NS_N = 128;        // the tile one block factorizes (npad)
constexpr int NS_LD = NS_N + 1;  // shared-memory row stride: rows fall in distinct banks
constexpr int NS_THREADS = 256;  // 16 x 16 threads, thread (ty, tx) owns rows ty+16r, cols tx+16c
constexpr int NS_MAX_MUS = 16;
constexpr size_t NS_SMEM_BYTES = 3 * NS_N * NS_LD * sizeof(float);  // K, X, T

// mu_schedule(a0, n_scaled) is computed on the host and passed by value.
struct NsSchedule {
  float mu[NS_MAX_MUS];
  int n_scaled;
  int n_quad;
  int n_hi;
};

inline NsSchedule make_schedule(const float* mus, int n_scaled, int n_quad, int n_hi) {
  NsSchedule s{};
  for (int i = 0; i < n_scaled && i < NS_MAX_MUS; ++i) s.mu[i] = mus[i];
  s.n_scaled = n_scaled;
  s.n_quad = n_quad;
  s.n_hi = n_hi;
  return s;
}

__device__ __forceinline__ void split_bf16(float a, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(a));
  lo = __bfloat162float(__float2bfloat16_rn(a - hi));
}

// acc = A @ B for the calling thread's 8 x 8 output grid; A and B are
// NS_N x NS_N tiles in shared memory with row stride NS_LD.
template <bool kBf16x3>
__device__ __forceinline__ void mm_tile(const float* __restrict__ A,
                                        const float* __restrict__ B,
                                        float (&acc)[8][8]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 2
  for (int k = 0; k < NS_N; ++k) {
    float a[8], b[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) a[r] = A[(ty + 16 * r) * NS_LD + k];
#pragma unroll
    for (int c = 0; c < 8; ++c) b[c] = B[k * NS_LD + tx + 16 * c];
    if (kBf16x3) {
      float ah[8], al[8], bh[8], bl[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) split_bf16(a[r], ah[r], al[r]);
#pragma unroll
      for (int c = 0; c < 8; ++c) split_bf16(b[c], bh[c], bl[c]);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc[r][c] = fmaf(ah[r], bh[c], acc[r][c]);
          acc[r][c] = fmaf(ah[r], bl[c], acc[r][c]);
          acc[r][c] = fmaf(al[r], bh[c], acc[r][c]);
        }
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
}

// One NS step: T = 2I - mu K X, then X = mu X T. mu = 1 gives the quadratic
// step exactly (1.0f * v == v).
template <bool kBf16x3>
__device__ __forceinline__ void ns_step(const float* K, float* X, float* T, float mu) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[8][8];
  mm_tile<kBf16x3>(K, X, acc);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int i = ty + 16 * r, j = tx + 16 * c;
      T[i * NS_LD + j] = (i == j ? 2.f : 0.f) - mu * acc[r][c];
    }
  __syncthreads();
  mm_tile<kBf16x3>(X, T, acc);
  __syncthreads();  // every read of X is done before it is overwritten
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) X[(ty + 16 * r) * NS_LD + tx + 16 * c] = mu * acc[r][c];
  __syncthreads();
}

// Runs the whole schedule on K (read only) into X; T is scratch. Every
// thread of the block must call it.
__device__ __forceinline__ void ns_schedule(const float* K, float* X, float* T,
                                            const NsSchedule& s) {
  __shared__ float warp_max[NS_THREADS / 32];
  const int tid = threadIdx.x;
  // alpha = 1 / max_i sum_j |K_ij|: rows on the first NS_N threads
  float row = 0.f;
  if (tid < NS_N) {
    for (int j = 0; j < NS_N; ++j) row += fabsf(K[tid * NS_LD + j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) row = fmaxf(row, __shfl_xor_sync(0xffffffffu, row, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = row;
  __syncthreads();
  float mx = warp_max[0];
#pragma unroll
  for (int w = 1; w < NS_THREADS / 32; ++w) mx = fmaxf(mx, warp_max[w]);
  const float alpha = 1.f / mx;
  for (int idx = tid; idx < NS_N * NS_N; idx += NS_THREADS) {
    const int i = idx / NS_N, j = idx % NS_N;
    X[i * NS_LD + j] = (i == j) ? alpha : 0.f;
  }
  __syncthreads();
  for (int it = 0; it < s.n_scaled; ++it) ns_step<true>(K, X, T, s.mu[it]);
  for (int it = 0; it < s.n_quad; ++it) ns_step<true>(K, X, T, 1.f);
  for (int it = 0; it < s.n_hi; ++it) ns_step<false>(K, X, T, 1.f);
}

}  // namespace qct
