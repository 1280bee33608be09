// Newton-Schulz core at the 128 tile, the products on the tensor cores. The
// factorization kernels of ns_inverse.cu run it (K2, K3, and K3 as the cold
// branch of K7), and so do the five factorizations of the fused solve K5
// (fused_admm.cu), with the tiles' roles rotated.
//
// One 256-thread block owns one Jacobi-scaled SPD system and keeps K, the
// iterate X and one scratch tile T resident in shared memory for the whole
// schedule, the role VMEM plays for the TPU kernels
// (quadruped_ctrl_tpu/ops/ns_inverse.py: _kernel_scaled_il,
// _kernel_scaled_build_il). The schedule is the TPU one, step for step:
//
//   X0 = I / max_i sum_j |K_ij|
//   scaled    (bf16x3):  X <- mu X (2I - mu K X)   for mu in mu_schedule(a0, n)
//   quadratic (bf16x3):  X <- X (2I - K X)         n_quad times
//   tail      (fp32):    X <- X (2I - K X)         n_hi times
//
// A bf16x3 product splits both operands into bf16 hi and lo (round to
// nearest) and sums hi*hi + hi*lo + lo*hi with fp32 accumulation (~1e-6
// relative). A single bf16 or TF32 pass is never used: NS diverges once
// cond x rounding error exceeds 1 (ns_inverse.py, the mixed-precision block
// comment).
//
// Residency. K, X and T stay fp32 (the tail needs all 24 bits; hi/lo planes
// would take the same 4 bytes an element), unpadded, their columns
// XOR-swizzled by 8 (row % 4) (mma.cuh's sw), so the mma
// fragment loads and the epilogue's float2 stores are free of bank
// conflicts: 3 x 65,536 bytes. B of a bf16x3 product is split into bf16 hi
// and lo planes once per product, in a double-buffered ring of two 16-row
// chunks (2 x 8,192 bytes), row k's 16-byte groups XOR-swizzled by k % 8 for
// ldmatrix.trans. The ring and not 64-row halves (32,768 bytes): B is the
// block's own tile, so a chunk is staged from shared memory in ~40
// instructions a thread, just before the chunk that precedes it is
// multiplied, and one barrier per chunk is all it costs; halves would stage
// 64 rows between two barriers with no mma to hide them under. Shared
// memory: 212,992 bytes, one block per SM.
//
// The product (mm_tile). 8 warps, each a 32 x 64 tile of the 128 x 128
// output in the mma accumulator layout (Acc, 2 x 8 fragments of 16 x 8), k in
// chunks of 16 in order. bf16x3: A's fragments are read from its fp32 tile and
// split as they load, B's from the chunk's planes (ldmatrix.trans); three
// mma.sync m16n8k16 bf16 passes (hi*hi, hi*lo, lo*hi) into one fp32
// accumulator. The fp32 tail runs as 3xTF32: hi = tf32(a), lo = tf32(a - hi)
// (cvt.rna), the same three passes as m16n8k8 tf32 mmas into a fresh
// accumulator per 16 k, which one fp32 add takes into the total; both
// operands are read straight from their fp32 tiles (no staging, no barrier).
// Accumulated in the mmas over all the terms, the tail loses ~4x fmaf's
// accuracy (PERF.md; probes/ns_cluster_probe.cu), which breaks the residual
// gates; 16 terms per add do not (tests/test_torch_ns_inverse.py holds this
// order of summation to the reference's gates on the CPU). The sums run in another
// order than the reference's, so results differ from it by rounding.
//
// What bounds it, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6;
// chip_smoke.py): a bf16x3 product is 12.6 MFLOP of bf16 passes, 2.7 us of
// mma.sync at the 621 TFLOP/s it reaches over 132 SMs, and takes ~5.4 us; a
// 3xTF32 tail product (the same passes as m16n8k8, 5.3 us of mma.sync at its
// rate) ~9.6 us. Around the mmas each warp splits its A fragments and its
// share of B on the CUDA cores and loads them from shared memory, with only 2
// warps a scheduler to hide that work; issuing the three passes over all
// accumulators in turn, or one barrier per two chunks (a ring of 4), did not
// help. K2 at 2048 systems of n = 120: 2.08 ms on the ADMM schedule, 2.58 ms
// on the polish schedule, 0.25 of the bound at the tensor cores' dense peaks;
// with the products as 128^3 fp32 FMAs per operand pair on the CUDA cores
// (3 per bf16x3 product), FMA-issue bound, it took 13.95 / 18.83 ms. Next:
// wgmma (asynchronous, B read from the planes in shared memory), so that the
// splits and the staging of the next chunk run while the tensor cores work.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma.cuh"

namespace qct {

constexpr int NS_N = 128;                // the tile one block factorizes (npad)
constexpr int NS_THREADS = 256;          // 8 warps: 4 x 2 warp tiles of 32 x 64
constexpr int NS_CHUNKS = NS_N / KC;     // chunks of 16 rows per product
constexpr int NS_TILE = NS_N * NS_N;     // floats per tile
constexpr int NS_STAGE = KC * NS_N;      // 32-bit words per staging buffer: hi and lo planes
constexpr int NS_MAX_MUS = 16;
// K, X, T and the two staging buffers: 196,608 + 16,384 bytes
constexpr size_t NS_SMEM_BYTES = (3 * NS_TILE + 2 * NS_STAGE) * sizeof(float);

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

using NsLane = Lane<NS_N>;

// The three tiles and the staging ring in dynamic shared memory.
struct NsTiles {
  float *K, *X, *T;
  uint32_t* S;
  __device__ __forceinline__ explicit NsTiles(float* smem)
      : K(smem), X(smem + NS_TILE), T(smem + 2 * NS_TILE),
        S(reinterpret_cast<uint32_t*>(smem + 3 * NS_TILE)) {}
};

// Rows [16c, 16c + 16) of B into the staging buffer st as bf16 hi and lo
// planes (stage_split). Each thread splits 2 float4: rows si and si + 8,
// columns 4 sj..4 sj + 3.
__device__ __forceinline__ void ns_stage(const float* B, int c, uint32_t* st) {
  const int si = threadIdx.x >> 5, sj = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int k = si + 8 * s;
    stage_split<NS_N>(st, *reinterpret_cast<const float4*>(B + sw<NS_N>(KC * c + k, 4 * sj)), k,
                      sj);
  }
}

// acc = A @ B for the calling warp's 32 x 64 tile; A and B are swizzled
// 128 x 128 tiles, S the staging ring. bf16x3: chunk c + 1 is staged before
// chunk c is multiplied, into the buffer chunk c - 1 used, and one barrier
// per chunk separates them. The caller's barrier must come between the
// product and any write to A, B or the ring; a bf16x3 product's first
// staging needs B complete and the ring free (a barrier since chunk 6 of
// the product before it).
template <bool kBf16x3>
__device__ __forceinline__ void mm_tile(const float* __restrict__ A, const float* __restrict__ B,
                                        uint32_t* S, Acc& acc) {
  const NsLane ln;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  if (kBf16x3) {
    ns_stage(B, 0, S);
    __syncthreads();
    for (int c = 0; c < NS_CHUNKS; ++c) {
      if (c + 1 < NS_CHUNKS) ns_stage(B, c + 1, S + ((c + 1) & 1) * NS_STAGE);
      mma_chunk_bf16(A, S + (c & 1) * NS_STAGE, KC * c, ln, acc);
      if (c + 1 < NS_CHUNKS) __syncthreads();  // chunk c + 1 staged; chunk c's reads done
    }
  } else {
    for (int c = 0; c < NS_CHUNKS; ++c) mma_chunk_tf32(A, B, KC * c, KC * c, ln, acc);
  }
}

// One NS step: T = 2I - mu K X, then X = mu X T. mu = 1 gives the quadratic
// step exactly (1.0f * v == v).
template <bool kBf16x3>
__device__ __forceinline__ void ns_step(const float* K, float* X, float* T, uint32_t* S, float mu) {
  Acc acc;
  mm_tile<kBf16x3>(K, X, S, acc);
  store_t<NS_N>(T, acc, mu);
  __syncthreads();  // T complete; the product's reads of X and of the ring are done
  mm_tile<kBf16x3>(X, T, S, acc);
  __syncthreads();  // every read of X is done before it is overwritten
  store_x<NS_N>(X, acc, mu);
  __syncthreads();
}

// Runs the whole schedule on K (read only) into X; T and the ring S are
// scratch. Every thread of the block must call it.
__device__ __forceinline__ void ns_schedule(const float* K, float* X, float* T, uint32_t* S,
                                            const NsSchedule& s) {
  __shared__ float warp_max[WARPS];
  const int tid = threadIdx.x;
  // alpha = 1 / max_i sum_j |K_ij|: row i on thread i < NS_N, its columns
  // from column i on, so that a warp's 32 reads fall in 32 banks
  float row = 0.f;
  if (tid < NS_N) {
    for (int j = 0; j < NS_N; ++j) row += fabsf(K[sw<NS_N>(tid, (j + tid) & (NS_N - 1))]);
  }
  const float alpha = 1.f / cta_max(row, warp_max);
  for (int idx = tid; idx < NS_TILE; idx += NS_THREADS) {
    const int i = idx / NS_N, j = idx % NS_N;
    X[sw<NS_N>(i, j)] = (i == j) ? alpha : 0.f;
  }
  __syncthreads();
  for (int it = 0; it < s.n_scaled; ++it) ns_step<true>(K, X, T, S, s.mu[it]);
  for (int it = 0; it < s.n_quad; ++it) ns_step<true>(K, X, T, S, 1.f);
  for (int it = 0; it < s.n_hi; ++it) ns_step<false>(K, X, T, S, 1.f);
}

}  // namespace qct
