// Factorization kernels at the 256 tile: one thread-block cluster of 4 CTAs
// per system, the Newton-Schulz products on the tensor cores.
//
// ns_inverse_scaled_256_kernel<false> replaces the TPU kernel
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_scaled (_kernel_scaled_il, npad 256)
// ns_inverse_scaled_build_256_kernel replaces
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_scaled_build
//   (_kernel_scaled_build_il, npad 256, emit_ks False)
// ns_inverse_scaled_256_kernel<true> is the cold branch of the guarded warm NS at
//   256 (quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_warm, _kernel_warm's
//   _cold region): the same kernel on the systems whose guard tripped
// (ns_refine.cu has the warm refinement K6 and the guard and warm branch of
// K7 at 256.)
//
// The schedule is the 128-tile core's (ns_core.cuh), step for step: alpha,
// the mu table, n_scaled + n_quad bf16x3 steps, n_hi fp32 steps. Residency:
// K, X and one scratch tile T at 256 x 256 floats take 786,432 bytes, over
// the 232,448 one block may use, so each system runs on a cluster of 4 CTAs
// on 4 SMs. CTA q owns rows [64q, 64q+64) of K, X and T (3 x 64 KB), and K,
// X and T never leave the cluster's shared memory for the whole schedule.
// One NS step:
//
//   T_q = 2I - mu K_q X     B = X: its 4 slabs, 3 of them over distributed
//                           shared memory (DSMEM), then cluster.sync()
//   X_q = mu X_q T          B = T the same way, then cluster.sync(), so no
//                           peer reads X or T while they are replaced
//
// and alpha = 1 / max_i sum_j |K_ij| is a cluster-wide max over DSMEM.
//
// The product (mm_slab). Each CTA computes its 64 x 256 slab of A B on the
// tensor cores; 8 warps, each a 32 x 64 tile (2 x 8 mma fragments of 16 x
// 8), k in chunks of 16. A bf16x3 product splits both operands into bf16 hi
// and lo (round to nearest, split_bf16's arithmetic) and runs hi*hi, hi*lo
// and lo*hi as three mma.sync m16n8k16 bf16 mmas into one fp32 accumulator.
// The fp32 tail runs as 3xTF32: hi = tf32(a), lo = tf32(a - hi) (cvt.rna),
// the same three passes as m16n8k8 tf32 mmas, into a fresh accumulator per
// chunk that one fp32 add takes into the total. Accumulated in the mmas over
// all 256 terms, the tail read ~4x the reference's residual on the polish
// schedule, over chip_smoke.py's 2x rule (PERF.md): the tensor cores' fp32
// accumulation is coarser than fmaf's over long sums, not over 16 terms.
// The sums run in another order than the reference's, so results differ
// from it by rounding (tests/test_torch_ns_inverse.py holds this order to
// the reference's residual gates on the CPU). The splits, the mmas, ldmatrix
// and each thread's place in the mma layouts (Lane) are mma.cuh's, shared
// with the 128 tile (ns_core.cuh).
//
// B is staged through a double-buffered ring of two 16-row chunks (16 KB
// each): every thread keeps its 4 float4 of the next two chunks in flight
// from the owning CTAs (ld.shared::cluster; those of chunk c + 2 start as
// soon as chunk c is staged), so the DSMEM traffic runs under the mmas and
// the staging, with one __syncthreads per chunk. The
// CTAs start on their own slab and walk the peers in turn, so each slab
// serves one peer at a time. A bf16x3 chunk is stored split, as hi and lo
// bf16 planes in an XOR-swizzled layout that ldmatrix.trans reads free of
// bank conflicts: each element of B is split once per CTA and product. A
// tail chunk stays fp32 and is split as it is read. A is the CTA's own slab,
// fp32, split as its fragments are read (each warp reads 32 rows). K, X and
// T stay fp32 in shared memory: the tail needs all 24 bits, and bf16 hi/lo
// planes would take the same 4 bytes an element. Their columns are
// XOR-swizzled by 8 (row % 4), so the fragment loads and the epilogue's
// stores are free of bank conflicts without padding. Shared memory:
// 3 x 65,536 bytes of slabs + 2 x 16,384 of staging = 229,376 bytes a CTA.
//
// What bounds it, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md;
// chip_smoke.py and probes/ns_cluster_probe.cu): a bf16x3 product of a CTA's
// slab takes ~11.7 us. Its parts alone: 6,144 bf16 mmas, ~5.3 us at the 621
// TFLOP/s mma.sync reaches over 132 SMs at 8 warps each; 3/4 of B (196,608
// bytes) over DSMEM, 6.8-7.7 us, ~8 us staged; and ~1.3 MB through the SM's
// shared memory (A fragments read by 4 warps, the B planes by 2, the staging
// stores, the peers' DSMEM reads), ~5.3 us at 128 bytes a clock. One barrier
// per chunk keeps every warp in the same phase, so they overlap only in
// part. K2 at 2048 systems of n = 192 takes 18.2 ms (ADMM schedule; 149.4 ms
// with the products on the CUDA cores) and 23.1 ms (polish), 0.23 of the
// bound at the tensor cores' dense 989 TFLOP/s, under torch.linalg.inv on
// the same matrices. The four limits of the CUDA-core kernel and what this
// design does about each:
//   1. bf16x3 as 3 fp32 FMAs per multiply-add: mma.sync on bf16 hi/lo, and
//      the tail on tf32 hi/lo;
//   2. both operands split on every read, 16 splits per thread per k: B is
//      split once per CTA as it is staged, A once per warp column (512
//      splits per thread per bf16x3 product in place of 4,096);
//   3. B copied from the peers in 32-row chunks between two __syncthreads,
//      overlapping nothing: two chunks' DSMEM loads stay in flight under the
//      mmas and the staging, one barrier per chunk;
//   4. one CTA per SM, 30 clusters on 120 of 132 SMs: unchanged. K, X and T
//      at 192 KB a CTA leave no room for a second CTA, and the 4-CTA
//      clusters do not tile every GPC.
// Next: producer warps that stage B while the mma warps compute (mbarriers,
// setmaxnreg: the 8 mma warps already hold 255 registers a thread), then
// wgmma and a 2 x 2 quadrant split of K, X and T (2 x 64 KB of DSMEM a
// product).
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "mma.cuh"
#include "ns_core.cuh"

namespace cg = cooperative_groups;

namespace qct {

constexpr int NC_N = 256;                  // the tile
constexpr int NC_CTAS = 4;                 // CTAs per system: one cluster
constexpr int NC_ROWS = NC_N / NC_CTAS;    // rows of K, X and T per CTA
constexpr int NC_THREADS = 256;            // 8 warps: 2 x 4 warp tiles of 32 x 64
constexpr int NC_CHUNKS = NC_N / KC;       // chunks of 16 rows per product
constexpr int NC_SLAB = NC_ROWS * NC_N;    // floats per slab
constexpr int NC_STAGE = KC * NC_N;        // 32-bit words per staging buffer
// K, X, T slabs and the two staging buffers: 196,608 + 32,768 bytes
constexpr size_t NC_SMEM_BYTES = (3 * NC_SLAB + 2 * NC_STAGE) * sizeof(float);

using NcLane = Lane<NC_N>;

// Store the 4 float4 of one chunk a thread loaded (rows si + 4s, columns
// 4 sj..4 sj+3) into a staging buffer. bf16x3: hi and lo planes of 16 x 256
// bf16, row k's 16-byte groups XOR-swizzled by k % 8 (ldmatrix.trans). fp32:
// 16 x 256 floats, columns XOR-swizzled by 8 (k % 4) (the tf32 fragments).
template <bool kBf16x3>
__device__ __forceinline__ void stage_store(uint32_t* st, const float4 (&v)[4], int si, int sj) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int k = si + 4 * s;
    if (kBf16x3) {
      stage_split<NC_N>(st, v[s], k, sj);
    } else {
      *reinterpret_cast<float4*>(st + k * NC_N + ((4 * sj) ^ (si << 3))) = v[s];
    }
  }
}

// acc = A_q @ B for the calling warp's 32 x 64 tile of this CTA's 64 x 256
// output. A_q (64 x 256) is this CTA's slab; B (256 x 256) is distributed:
// its rows [64p, 64p+64) are the slab at `b_slab` in CTA p's shared memory.
// B goes through the two staging buffers at S in chunks of 16 rows. Each
// thread keeps two chunks' DSMEM loads in flight (v0, v1): the loads of
// chunk c + 2 start as soon as chunk c is staged, so the DSMEM traffic,
// which takes longer than a chunk's mmas, never waits on the staging.
template <bool kBf16x3>
__device__ __forceinline__ void mm_slab(const float* __restrict__ A, const float* b_slab,
                                        uint32_t* S, Acc& acc) {
  const NcLane ln;
  const int q = static_cast<int>(cg::this_cluster().block_rank());
  const int si = threadIdx.x >> 6, sj = threadIdx.x & 63;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // this thread's float4 of a chunk: rows si + 4s (row % 4 == si), columns 4 sj..
  const uint32_t b_own = smem_addr(b_slab) + (si * NC_N + ((4 * sj) ^ (si << 3))) * 4;
  auto load = [&](int c, float4 (&v)[4]) {
    const uint32_t base = map_rank(b_own, (q + c / 4) & 3) + (c & 3) * KC * NC_N * 4;
#pragma unroll
    for (int s = 0; s < 4; ++s) v[s] = ld_cluster(base + s * 4 * NC_N * 4);
  };
  auto chunk = [&](int c, float4 (&v)[4]) {
    uint32_t* st = S + (c & 1) * NC_STAGE;
    stage_store<kBf16x3>(st, v, si, sj);
    __syncthreads();  // chunk c staged; every read of chunk c - 2's buffer is done
    if (c + 2 < NC_CHUNKS) load(c + 2, v);
    const int kg = ((q + c / 4) & 3) * NC_ROWS + (c & 3) * KC;  // B's first row in chunk c
    if (kBf16x3) {
      mma_chunk_bf16(A, st, kg, ln, acc);
    } else {
      mma_chunk_tf32(A, reinterpret_cast<const float*>(st), 0, kg, ln, acc);
    }
  };
  float4 v0[4], v1[4];
  load(0, v0);
  load(1, v1);
  for (int c = 0; c < NC_CHUNKS; c += 2) {
    chunk(c, v0);
    chunk(c + 1, v1);
  }
}

// One NS step on the cluster: T = 2I - mu K X, then X = mu X T. row0 is the
// first global row of this CTA's slab.
template <bool kBf16x3>
__device__ __forceinline__ void nc_step(const float* K, float* X, float* T, uint32_t* S, float mu,
                                        int row0) {
  cg::cluster_group cluster = cg::this_cluster();
  Acc acc;
  mm_slab<kBf16x3>(K, X, S, acc);
  store_t<NC_N>(T, acc, mu, row0);
  cluster.sync();  // T complete in every CTA; every read of X is done
  mm_slab<kBf16x3>(X, T, S, acc);
  __syncthreads();  // this CTA's reads of its X slab are done
  store_x<NC_N>(X, acc, mu);
  cluster.sync();  // X complete in every CTA; every read of T is done
}

// The largest of `slab_v` over the cluster's 4 CTAs, in every thread. Each
// CTA writes its own slab_v before the barrier.
__device__ __forceinline__ float cluster_max(float* slab_v) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float mx = *slab_v;
#pragma unroll
  for (int p = 0; p < NC_CTAS; ++p) mx = fmaxf(mx, *cluster.map_shared_rank(slab_v, p));
  return mx;
}

// The whole schedule on the cluster's K slabs into its X slabs. Every thread
// of every CTA of the cluster must call it.
__device__ __forceinline__ void nc_schedule(const float* K, float* X, float* T, uint32_t* S,
                                            const NsSchedule& s, int row0) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float warp_max[NC_THREADS / 32];
  __shared__ float slab_max;
  const int tid = threadIdx.x;
  // alpha = 1 / max_i sum_j |K_ij|: this slab's rows on the first 64 threads,
  // then the max over the cluster's 4 slabs
  float row = 0.f;
  if (tid < NC_ROWS) {
    for (int j = 0; j < NC_N; ++j) row += fabsf(K[sw<NC_N>(tid, j)]);
  }
  const float mx = cta_max(row, warp_max);
  if (tid == 0) slab_max = mx;
  const float alpha = 1.f / cluster_max(&slab_max);
  for (int idx = tid; idx < NC_SLAB; idx += NC_THREADS) {
    const int i = idx / NC_N, j = idx % NC_N;
    X[sw<NC_N>(i, j)] = (row0 + i == j) ? alpha : 0.f;
  }
  cluster.sync();  // X complete; every peer has read slab_max
  for (int it = 0; it < s.n_scaled; ++it) nc_step<true>(K, X, T, S, s.mu[it], row0);
  for (int it = 0; it < s.n_quad; ++it) nc_step<true>(K, X, T, S, 1.f, row0);
  for (int it = 0; it < s.n_hi; ++it) nc_step<false>(K, X, T, S, 1.f, row0);
}

__device__ __forceinline__ void load_slab(const float* __restrict__ src, float* dst) {
  for (int idx = threadIdx.x; idx < NC_SLAB; idx += NC_THREADS) {
    dst[sw<NC_N>(idx / NC_N, idx % NC_N)] = src[idx];
  }
}

__device__ __forceinline__ void store_slab(const float* X, float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < NC_SLAB; idx += NC_THREADS) {
    dst[idx] = X[sw<NC_N>(idx / NC_N, idx % NC_N)];
  }
}

// The three slabs and the staging ring in dynamic shared memory.
struct Slabs {
  float *K, *X, *T;
  uint32_t* S;
  __device__ __forceinline__ explicit Slabs(float* smem)
      : K(smem), X(smem + NC_SLAB), T(smem + 2 * NC_SLAB),
        S(reinterpret_cast<uint32_t*>(smem + 3 * NC_SLAB)) {}
};

// ks (B, 256, 256) Jacobi-scaled, identity on the pad -> inv (B, 256, 256).
// Grid: 4 CTAs per system, the 4 CTAs of system b are blocks 4b..4b+3.
// kMasked: only the systems whose flag in `tripped` is not 0 (ns_refine.cu's
// guard sets them); the 4 CTAs of a system whose flag is 0 return at once,
// before any barrier, and store nothing. Otherwise `tripped` is not read.
template <bool kMasked>
__global__ void __cluster_dims__(NC_CTAS, 1, 1) __launch_bounds__(NC_THREADS)
ns_inverse_scaled_256_kernel(const float* __restrict__ ks, float* __restrict__ inv,
                             NsSchedule s, const int* __restrict__ tripped) {
  if (kMasked && tripped[blockIdx.x / NC_CTAS] == 0) return;
  extern __shared__ __align__(128) float smem[];
  const Slabs m(smem);
  const int row0 = static_cast<int>(cg::this_cluster().block_rank()) * NC_ROWS;
  const size_t base = static_cast<size_t>(blockIdx.x / NC_CTAS) * NC_N * NC_N +
                      static_cast<size_t>(row0) * NC_N;
  load_slab(ks + base, m.K);
  __syncthreads();
  nc_schedule(m.K, m.X, m.T, m.S, s, row0);
  store_slab(m.X, inv + base);
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
  extern __shared__ __align__(128) float smem[];
  const Slabs m(smem);
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
  for (int idx = threadIdx.x; idx < NC_SLAB; idx += NC_THREADS) {
    const int i = idx / NC_N, c = idx % NC_N;
    const int r = row0 + i;
    float v = hp[base + static_cast<size_t>(r) * NC_N + c];
    const int blk = c / 3;
    if (r / 3 == blk && blk < nblk) v += g[(3 * (r % 3) + c % 3) * nblk + blk];
    m.K[sw<NC_N>(i, c)] = v * d[r] * d[c];
  }
  __syncthreads();
  nc_schedule(m.K, m.X, m.T, m.S, s, row0);
  store_slab(m.X, inv + base + static_cast<size_t>(row0) * NC_N);
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
  cudaError_t err = qct::allow_cluster_smem(qct::ns_inverse_scaled_256_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_scaled_256_kernel<false><<<b * qct::NC_CTAS, qct::NC_THREADS,
                                             qct::NC_SMEM_BYTES,
                                             static_cast<cudaStream_t>(stream)>>>(
      ks, inv, qct::make_schedule(mus, n_scaled, n_quad, n_hi), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K3 at 256 on the systems of ks whose flag in tripped (b int32) is not 0:
// the cold branch of the guarded warm NS (ns_refine.cu: qct_ns_inverse_warm_256).
extern "C" int qct_ns_inverse_scaled_masked_256(const float* ks, float* inv, const int* tripped,
                                                int b, const float* mus, int n_scaled,
                                                int n_quad, int n_hi, void* stream) {
  if (n_scaled > qct::NS_MAX_MUS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = qct::allow_cluster_smem(qct::ns_inverse_scaled_256_kernel<true>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::ns_inverse_scaled_256_kernel<true><<<b * qct::NC_CTAS, qct::NC_THREADS,
                                            qct::NC_SMEM_BYTES,
                                            static_cast<cudaStream_t>(stream)>>>(
      ks, inv, qct::make_schedule(mus, n_scaled, n_quad, n_hi), tripped);
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

// Clusters of the 256-tile kernel the card can hold at once (0: it cannot
// run). For the record in chip_smoke.py; the launches do not need it.
extern "C" int qct_ns_cluster_max_active(int* clusters) {
  cudaError_t err = qct::allow_cluster_smem(qct::ns_inverse_scaled_256_kernel<false>);
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
      cudaOccupancyMaxActiveClusters(clusters, qct::ns_inverse_scaled_256_kernel<false>, &cfg));
}
