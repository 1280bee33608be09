// Factorization kernels at the 256 tile: one thread-block cluster of 4 CTAs
// per system.
//
// ns_inverse_scaled_256_kernel replaces the TPU kernel
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_scaled (_kernel_scaled_il, npad 256)
// ns_inverse_scaled_build_256_kernel replaces
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_scaled_build
//   (_kernel_scaled_build_il, npad 256, emit_ks False)
// ns_inverse_refine_256_kernel replaces
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_refine (_kernel_refine, npad 256)
// ns_inverse_warm_256_kernel replaces
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_warm (_kernel_warm, npad 256)
// qct_ns_inverse_plain_256 launches ns_inverse_scaled_256_kernel in place of
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas and
//   ns_inverse_pallas_blocked (npad 256)
//
// The schedule, the bf16x3 split-on-read products and the fp32 tail are those
// of the 128-tile core (ns_core.cuh), step for step; only the residency
// differs. The TPU kernels keep K, X and T of a 256 system in VMEM. Here K, X
// and one scratch tile T at 256 x 257 floats each would take 789,504 bytes,
// over the 232,448 one block may use. So each system runs on a cluster of 4
// CTAs on 4 SMs (chosen over a single block streaming K and X from L2, which
// would re-read 512 KB from L2 per product): CTA q owns rows [64q, 64q+64)
// of K, X and T, 3 x 64 x 257 floats = 197,376 bytes, the budget of the
// 128-tile kernel at one block per SM, and K, X and T never leave the
// cluster's shared memory for the whole schedule. One NS step:
//
//   T_q = 2I - mu K_q X     reads the 4 slabs of X over distributed shared
//                           memory (DSMEM), then cluster.sync()
//   X_q = mu X_q T          reads the 4 slabs of T the same way, then
//                           cluster.sync(), so no peer reads X or T while
//                           they are replaced
//
// and alpha = 1 / max_i sum_j |K_ij| is a cluster-wide max over DSMEM.
//
// What bounds it on an H100: each CTA does the 64 x 256 x 256 products of its
// slab with fp32 FMAs on the CUDA cores (3 per bf16x3 product), 2x the work of
// a 128-tile block, so the kernel is FMA-issue bound as the 128 kernel is,
// plus the DSMEM reads of 3/4 of every B operand and two cluster barriers per
// step. At 8 warps per SM a DSMEM load per product step left the FMAs
// waiting (K2 at 2048 systems of n = 192, ADMM schedule: 195.4 ms on an H100
// 80GB HBM3 at 700 W, chip_smoke.py): the B operand is copied 32 rows at a
// time into a 32 KB staging buffer, the shared memory left beside the slabs,
// with 32 loads in flight per thread (149.3 ms); the sums still run over k
// in order, so the result is unchanged. Each thread keeps an 8 x 8 output
// grid (rows ty + 8i, cols tx + 32j): a warp reads one broadcast A value and
// 32 consecutive B values per k. Only 30 clusters fit on the card at once
// (120 of 132 SMs). The tensor cores (mma / wgmma on pre-split hi/lo
// operands) are a later step.
#include <cooperative_groups.h>

#include <cstdint>

#include "ns_core.cuh"

namespace cg = cooperative_groups;

namespace qct {

constexpr int NC_N = 256;                  // the tile
constexpr int NC_CTAS = 4;                 // CTAs per system: one cluster
constexpr int NC_ROWS = NC_N / NC_CTAS;    // rows of K, X and T per CTA
constexpr int NC_LD = NC_N + 1;            // shared-memory row stride
constexpr int NC_THREADS = 256;            // 8 x 32 threads
constexpr int NC_CHUNK = 32;               // rows of a B operand staged at a time
// K, X, T slabs and the staging buffer: 197,376 + 32,768 bytes
constexpr size_t NC_SMEM_BYTES = (3 * NC_ROWS * NC_LD + NC_CHUNK * NC_N) * sizeof(float);

// acc = A_q @ B for the calling thread's 8 x 8 grid of this CTA's 64 x 256
// output. A_q (64 x 256) is this CTA's slab; B (256 x 256) is distributed:
// its rows [64p, 64p+64) are the slab at offset `b_slab` in CTA p's shared
// memory. B is read in chunks of NC_CHUNK rows, each first copied into the
// CTA's staging buffer S: 32 loads in flight per thread instead of one
// DSMEM round trip per product step. The sum runs over k in order, as
// without staging.
template <bool kBf16x3>
__device__ __forceinline__ void mm_slab(const float* __restrict__ A, float* b_slab,
                                        float* __restrict__ S, float (&acc)[8][8]) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  for (int p = 0; p < NC_CTAS; ++p) {
    const float* B = cluster.map_shared_rank(b_slab, p);
    for (int k0 = 0; k0 < NC_ROWS; k0 += NC_CHUNK) {
      __syncthreads();  // every read of the previous chunk is done
#pragma unroll 8
      for (int idx = threadIdx.x; idx < NC_CHUNK * NC_N; idx += NC_THREADS) {
        S[idx] = B[(k0 + idx / NC_N) * NC_LD + idx % NC_N];
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < NC_CHUNK; ++kk) {
        const int k = p * NC_ROWS + k0 + kk;
        float a[8], b[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) a[r] = A[(ty + 8 * r) * NC_LD + k];
#pragma unroll
        for (int c = 0; c < 8; ++c) b[c] = S[kk * NC_N + tx + 32 * c];
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
  }
}

// One NS step on the cluster: T = 2I - mu K X, then X = mu X T. row0 is the
// first global row of this CTA's slab.
template <bool kBf16x3>
__device__ __forceinline__ void nc_step(const float* K, float* X, float* T, float* S, float mu,
                                        int row0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  float acc[8][8];
  mm_slab<kBf16x3>(K, X, S, acc);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int i = ty + 8 * r, j = tx + 32 * c;
      T[i * NC_LD + j] = (row0 + i == j ? 2.f : 0.f) - mu * acc[r][c];
    }
  cluster.sync();  // T complete in every CTA; every read of X is done
  mm_slab<kBf16x3>(X, T, S, acc);
  __syncthreads();  // this CTA's reads of its X slab are done
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) X[(ty + 8 * r) * NC_LD + tx + 32 * c] = mu * acc[r][c];
  cluster.sync();  // X complete in every CTA; every read of T is done
}

// The whole schedule on the cluster's K slabs into its X slabs. Every thread
// of every CTA of the cluster must call it.
__device__ __forceinline__ void nc_schedule(const float* K, float* X, float* T, float* S,
                                            const NsSchedule& s, int row0) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float warp_max[NC_THREADS / 32];
  __shared__ float slab_max;
  const int tid = threadIdx.x;
  // alpha = 1 / max_i sum_j |K_ij|: this slab's rows on the first 64 threads,
  // then the max over the cluster's 4 slabs
  float row = 0.f;
  if (tid < NC_ROWS) {
    for (int j = 0; j < NC_N; ++j) row += fabsf(K[tid * NC_LD + j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) row = fmaxf(row, __shfl_xor_sync(0xffffffffu, row, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = row;
  __syncthreads();
  if (tid == 0) {
    float mx = warp_max[0];
#pragma unroll
    for (int w = 1; w < NC_THREADS / 32; ++w) mx = fmaxf(mx, warp_max[w]);
    slab_max = mx;
  }
  cluster.sync();
  float mx = 0.f;
#pragma unroll
  for (int p = 0; p < NC_CTAS; ++p) mx = fmaxf(mx, *cluster.map_shared_rank(&slab_max, p));
  const float alpha = 1.f / mx;
  for (int idx = tid; idx < NC_ROWS * NC_N; idx += NC_THREADS) {
    const int i = idx / NC_N, j = idx % NC_N;
    X[i * NC_LD + j] = (row0 + i == j) ? alpha : 0.f;
  }
  cluster.sync();
  for (int it = 0; it < s.n_scaled; ++it) nc_step<true>(K, X, T, S, s.mu[it], row0);
  for (int it = 0; it < s.n_quad; ++it) nc_step<true>(K, X, T, S, 1.f, row0);
  for (int it = 0; it < s.n_hi; ++it) nc_step<false>(K, X, T, S, 1.f, row0);
}

__device__ __forceinline__ void store_slab(const float* X, float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < NC_ROWS * NC_N; idx += NC_THREADS) {
    dst[idx] = X[(idx / NC_N) * NC_LD + idx % NC_N];
  }
}

// ks (B, 256, 256) Jacobi-scaled, identity on the pad -> inv (B, 256, 256).
// Grid: 4 CTAs per system, the 4 CTAs of system b are blocks 4b..4b+3.
__global__ void __cluster_dims__(NC_CTAS, 1, 1) __launch_bounds__(NC_THREADS)
ns_inverse_scaled_256_kernel(const float* __restrict__ ks, float* __restrict__ inv,
                             NsSchedule s) {
  extern __shared__ float smem[];
  float* K = smem;
  float* X = K + NC_ROWS * NC_LD;
  float* T = X + NC_ROWS * NC_LD;
  float* S = T + NC_ROWS * NC_LD;
  const int row0 = static_cast<int>(cg::this_cluster().block_rank()) * NC_ROWS;
  const size_t base = static_cast<size_t>(blockIdx.x / NC_CTAS) * NC_N * NC_N +
                      static_cast<size_t>(row0) * NC_N;
  for (int idx = threadIdx.x; idx < NC_ROWS * NC_N; idx += NC_THREADS) {
    K[(idx / NC_N) * NC_LD + idx % NC_N] = ks[base + idx];
  }
  __syncthreads();
  nc_schedule(K, X, T, S, s, row0);
  store_slab(X, inv + base);
}

// K = hp + blockdiag3(g9), d = rsqrt(max(diag K, 1e-30)), ks = D K D, then the
// schedule on ks, as ns_inverse_scaled_build_kernel at the 128 tile. Each CTA
// builds its own 64 rows element by element (slab edges at rows 64, 128 and
// 192 cut 3 x 3 blocks) and computes the whole d from hp's diagonal and g9's
// diagonal entries. Writes inv (B, 256, 256) and d_row (B, 256); no ks.
__global__ void __cluster_dims__(NC_CTAS, 1, 1) __launch_bounds__(NC_THREADS)
ns_inverse_scaled_build_256_kernel(const float* __restrict__ hp, const float* __restrict__ g9,
                                   int nblk, float* __restrict__ inv,
                                   float* __restrict__ d_row, NsSchedule s) {
  extern __shared__ float smem[];
  float* K = smem;
  float* X = K + NC_ROWS * NC_LD;
  float* T = X + NC_ROWS * NC_LD;
  float* S = T + NC_ROWS * NC_LD;
  __shared__ float d[NC_N];
  const int row0 = static_cast<int>(cg::this_cluster().block_rank()) * NC_ROWS;
  const size_t sys = blockIdx.x / NC_CTAS;
  const size_t base = sys * NC_N * NC_N;
  const float* g = g9 + sys * 9 * nblk;
  for (int i = threadIdx.x; i < NC_N; i += NC_THREADS) {
    float v = hp[base + static_cast<size_t>(i) * NC_N + i];
    const int blk = i / 3;
    if (blk < nblk) v += g[(3 * (i % 3) + i % 3) * nblk + blk];
    d[i] = 1.f / sqrtf(fmaxf(v, 1e-30f));
  }
  __syncthreads();
  if (threadIdx.x < NC_ROWS) d_row[sys * NC_N + row0 + threadIdx.x] = d[row0 + threadIdx.x];
  for (int idx = threadIdx.x; idx < NC_ROWS * NC_N; idx += NC_THREADS) {
    const int i = idx / NC_N, c = idx % NC_N;
    const int r = row0 + i;
    float v = hp[base + static_cast<size_t>(r) * NC_N + c];
    const int blk = c / 3;
    if (r / 3 == blk && blk < nblk) v += g[(3 * (r % 3) + c % 3) * nblk + blk];
    K[i * NC_LD + c] = v * d[r] * d[c];
  }
  __syncthreads();
  nc_schedule(K, X, T, S, s, row0);
  store_slab(X, inv + base + static_cast<size_t>(row0) * NC_N);
}

// Guard-free warm NS at the 256 tile, as ns_inverse_refine_kernel at 128: each
// CTA loads its 64-row slabs of ks and of init (in place of alpha I), then
// n_quad bf16x3 and n_hi fp32 quadratic steps on the cluster.
__global__ void __cluster_dims__(NC_CTAS, 1, 1) __launch_bounds__(NC_THREADS)
ns_inverse_refine_256_kernel(const float* __restrict__ ks, const float* __restrict__ init,
                             float* __restrict__ inv, int n_quad, int n_hi) {
  extern __shared__ float smem[];
  float* K = smem;
  float* X = K + NC_ROWS * NC_LD;
  float* T = X + NC_ROWS * NC_LD;
  float* S = T + NC_ROWS * NC_LD;
  const int row0 = static_cast<int>(cg::this_cluster().block_rank()) * NC_ROWS;
  const size_t base = static_cast<size_t>(blockIdx.x / NC_CTAS) * NC_N * NC_N +
                      static_cast<size_t>(row0) * NC_N;
  for (int idx = threadIdx.x; idx < NC_ROWS * NC_N; idx += NC_THREADS) {
    K[(idx / NC_N) * NC_LD + idx % NC_N] = ks[base + idx];
    X[(idx / NC_N) * NC_LD + idx % NC_N] = init[base + idx];
  }
  cg::this_cluster().sync();  // every slab of X is loaded before a peer reads it
  for (int it = 0; it < n_quad; ++it) nc_step<true>(K, X, T, S, 1.f, row0);
  for (int it = 0; it < n_hi; ++it) nc_step<false>(K, X, T, S, 1.f, row0);
  store_slab(X, inv + base);
}

// Guarded warm NS at the 256 tile, as ns_inverse_warm_kernel at 128: each CTA
// loads its 64-row slabs of ks and of init (straight into the X slab, so the
// three slabs and the staging buffer are all the shared memory it needs),
// forms its slab of T = 2I - K X0 (bf16x3) and the largest row sum of
// |I - K X0| over its rows. r0 is the max over the cluster's 4 slabs, read over
// DSMEM after the barrier that completes T, exactly as alpha is: every CTA
// holds the same r0 and takes the same branch, which the cluster.sync() calls
// inside the steps require. Below the guard the first warm step completes
// from that T; otherwise nc_schedule runs, K3's own code.
__global__ void __cluster_dims__(NC_CTAS, 1, 1) __launch_bounds__(NC_THREADS)
ns_inverse_warm_256_kernel(const float* __restrict__ ks, const float* __restrict__ init,
                           float* __restrict__ inv, NsSchedule s, int n_wquad, int n_whi,
                           float guard) {
  extern __shared__ float smem[];
  float* K = smem;
  float* X = K + NC_ROWS * NC_LD;
  float* T = X + NC_ROWS * NC_LD;
  float* S = T + NC_ROWS * NC_LD;
  __shared__ float warp_max[NC_THREADS / 32];
  __shared__ float slab_r0;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int row0 = static_cast<int>(cluster.block_rank()) * NC_ROWS;
  const size_t base = static_cast<size_t>(blockIdx.x / NC_CTAS) * NC_N * NC_N +
                      static_cast<size_t>(row0) * NC_N;
  for (int idx = tid; idx < NC_ROWS * NC_N; idx += NC_THREADS) {
    K[(idx / NC_N) * NC_LD + idx % NC_N] = ks[base + idx];
    X[(idx / NC_N) * NC_LD + idx % NC_N] = init[base + idx];
  }
  cluster.sync();  // every slab of X is loaded before a peer reads it
  float acc[8][8];
  mm_slab<true>(K, X, S, acc);
  float rmax = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 8 * r;
    float row = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = tx + 32 * c;
      row += fabsf((row0 + i == j ? 1.f : 0.f) - acc[r][c]);
      T[i * NC_LD + j] = (row0 + i == j ? 2.f : 0.f) - acc[r][c];
    }
    // row i's 256 entries lie on the warp's 32 lanes
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) row += __shfl_xor_sync(0xffffffffu, row, off);
    rmax = fmaxf(rmax, isnan(row) ? INFINITY : row);  // fmaxf drops NaN: a NaN start fails
  }
  if (tx == 0) warp_max[ty] = rmax;
  __syncthreads();
  if (tid == 0) {
    float mx = warp_max[0];
#pragma unroll
    for (int w = 1; w < NC_THREADS / 32; ++w) mx = fmaxf(mx, warp_max[w]);
    slab_r0 = mx;
  }
  cluster.sync();  // T and slab_r0 complete in every CTA; every read of X is done
  float r0 = slab_r0;
#pragma unroll
  for (int p = 0; p < NC_CTAS; ++p) r0 = fmaxf(r0, *cluster.map_shared_rank(&slab_r0, p));
  if (r0 < guard) {
    mm_slab<true>(X, T, S, acc);
    __syncthreads();  // this CTA's reads of its X slab are done
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) X[(ty + 8 * r) * NC_LD + tx + 32 * c] = acc[r][c];
    cluster.sync();  // X complete in every CTA; every read of T is done
    for (int it = 1; it < n_wquad; ++it) nc_step<true>(K, X, T, S, 1.f, row0);
    for (int it = 0; it < n_whi; ++it) nc_step<false>(K, X, T, S, 1.f, row0);
  } else {
    nc_schedule(K, X, T, S, s, row0);
  }
  store_slab(X, inv + base);
}

template <typename Kernel>
cudaError_t allow_cluster_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(NC_SMEM_BYTES));
}

}  // namespace qct

// C entry points (loaded with ctypes). Each returns the launch's cudaError_t;
// the caller checks bounds, types and the schedule length.
extern "C" int qct_ns_inverse_scaled_256(const float* ks, float* inv, int b, const float* mus,
                                         int n_scaled, int n_quad, int n_hi, void* stream) {
  if (n_scaled > qct::NS_MAX_MUS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = qct::allow_cluster_smem(qct::ns_inverse_scaled_256_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_scaled_256_kernel<<<b * qct::NC_CTAS, qct::NC_THREADS, qct::NC_SMEM_BYTES,
                                      static_cast<cudaStream_t>(stream)>>>(
      ks, inv, qct::make_schedule(mus, n_scaled, n_quad, n_hi));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qct_ns_inverse_scaled_build_256(const float* hp, const float* g9, int nblk,
                                               float* inv, float* d_row, int b, const float* mus,
                                               int n_scaled, int n_quad, int n_hi,
                                               void* stream) {
  if (n_scaled > qct::NS_MAX_MUS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = qct::allow_cluster_smem(qct::ns_inverse_scaled_build_256_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_scaled_build_256_kernel<<<b * qct::NC_CTAS, qct::NC_THREADS,
                                            qct::NC_SMEM_BYTES,
                                            static_cast<cudaStream_t>(stream)>>>(
      hp, g9, nblk, inv, d_row, qct::make_schedule(mus, n_scaled, n_quad, n_hi));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qct_ns_inverse_refine_256(const float* ks, const float* init, float* inv, int b,
                                         int n_quad, int n_hi, void* stream) {
  cudaError_t err = qct::allow_cluster_smem(qct::ns_inverse_refine_256_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_refine_256_kernel<<<b * qct::NC_CTAS, qct::NC_THREADS, qct::NC_SMEM_BYTES,
                                      static_cast<cudaStream_t>(stream)>>>(ks, init, inv,
                                                                           n_quad, n_hi);
  return static_cast<int>(cudaGetLastError());
}

// Plain fp32 NS at the 256 tile (ns_inverse_pallas / ns_inverse_pallas_blocked,
// npad 256): the scaled kernel on a schedule of `iters` fp32 steps alone.
extern "C" int qct_ns_inverse_plain_256(const float* ks, float* inv, int b, int iters,
                                        void* stream) {
  cudaError_t err = qct::allow_cluster_smem(qct::ns_inverse_scaled_256_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_scaled_256_kernel<<<b * qct::NC_CTAS, qct::NC_THREADS, qct::NC_SMEM_BYTES,
                                      static_cast<cudaStream_t>(stream)>>>(
      ks, inv, qct::make_schedule(nullptr, 0, 0, iters));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qct_ns_inverse_warm_256(const float* ks, const float* init, float* inv, int b,
                                       const float* mus, int n_scaled, int n_quad, int n_hi,
                                       int n_wquad, int n_whi, float guard, void* stream) {
  if (n_scaled > qct::NS_MAX_MUS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = qct::allow_cluster_smem(qct::ns_inverse_warm_256_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_warm_256_kernel<<<b * qct::NC_CTAS, qct::NC_THREADS, qct::NC_SMEM_BYTES,
                                    static_cast<cudaStream_t>(stream)>>>(
      ks, init, inv, qct::make_schedule(mus, n_scaled, n_quad, n_hi), n_wquad, n_whi, guard);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the 256-tile kernel the card can hold at once (0: it cannot
// run). For the record in chip_smoke.py; the launches do not need it.
extern "C" int qct_ns_cluster_max_active(int* clusters) {
  cudaError_t err = qct::allow_cluster_smem(qct::ns_inverse_scaled_256_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(qct::NC_CTAS * 64, 1, 1);
  cfg.blockDim = dim3(qct::NC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = qct::NC_SMEM_BYTES;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = qct::NC_CTAS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, qct::ns_inverse_scaled_256_kernel, &cfg));
}
