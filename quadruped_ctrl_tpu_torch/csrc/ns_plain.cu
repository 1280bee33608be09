// The plain fp32 Newton-Schulz inverse on thread-block clusters: K8 (one
// system) at both tiles and K9 (a batch) at the 256 tile.
//
// ns_plain_kernel<128, 2, 4> and ns_plain_kernel<256, 4, 4> replace the TPU kernel
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas (_kernel), npad 128 and 256
// ns_plain_kernel<256, 4, 1> replaces
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_blocked (_kernel_blocked), npad 256
// (K9 at the 128 tile runs on ns_refine.cu's wgmma step: qct_ns_inverse_plain.)
//
// What they compute, as the TPU kernels do: alpha = 1 / max_i sum_j |K_ij|,
// X0 = alpha I, then `iters` steps T = 2I - K X, X <- X T, every product
// fp32-grade: 3xTF32 (hi = tf32(a), lo = tf32(a - hi), cvt.rna; the passes
// hi*hi, hi*lo, lo*hi) with fp32 accumulation. The passes of each run of 16
// k run into a fresh accumulator that one fp32 add takes into the total: the
// tensor cores' own accumulation over long runs loses ~4x fmaf's accuracy
// (PERF.md; probes/ns_cluster_probe.cu), runs of 16 hold the gates
// (tests/test_torch_ns_inverse.py models this order on the CPU). The sums
// run in another order than the reference's, so results differ from it by
// rounding.
//
// Layout. A system runs on one cluster of kR x kC CTAs of 256 threads (two
// warpgroups). CTA (i, j) (cluster rank i kC + j) owns the 64 x kNB block
// (i, j) of X and of T (rows [64 i, 64 i + 64), columns [kNB j, kNB j +
// kNB), kNB = npad / kC) and holds rows [64 i, 64 i + 64) of K. One step:
//
//   T_ij = 2I - K_i. X_.j    A = its own K rows; B = X's column block j, the
//                            blocks (i', j) of kR CTAs; meanwhile the CTA
//                            gathers X's row block i (the blocks (i, j') of
//                            kC CTAs) into XR, then cluster.sync()
//   X_ij = XR_i. T_.j        A = XR; B = T's column block j, then
//                            cluster.sync(), so no peer reads X or T while
//                            they are replaced
//
// With kC = 1 (K9) a block is a whole row slab, XR is X itself and nothing is
// gathered, the design of the first 256-tile K3. The 2-D blocks are for one system
// on a wide cluster, where distributed shared memory (DSMEM) bounds a step
// (~30 GB/s per SM; probes/ns_plain_probe.cu, PERF.md section 6): at npad
// 256 on 16 CTAs, row slabs of 16 would pull 15/16 of X and of T a step, 480
// KB a CTA; 4 x 4 blocks of 64 x 64 pull 3/4 of a column block of X and of T
// and of X's row block, 144 KB. At npad 128, 2 x 4 blocks of 64 x 32 pull 40
// KB a step a CTA where slabs of 16 on 8 CTAs would pull 112 KB.
//
// Every tile (K, XR, X, T) is stored as B-ready chunks of 8 rows: element
// (r, c) of a tile kW wide at blk<kW>(r, c), the K-major core-matrix layout
// that wgmma reads B in (mma.cuh), so any kKB rows of a block are one
// contiguous run that a peer copies as it is.
//
// The product (plain_product). Each warpgroup computes half of the CTA's
// 64 x kNB block with wgmma m64n(kNB/2)k8, A from registers, B from shared
// memory (probes/ns_plain_probe.cu: a 64 x 256 x 256 3xTF32 product takes
// ~19 us as mma.sync m16n8k8 on one SM, ~11 us as wgmma). B is pulled from
// its owners stage by stage (kKB rows: ld.shared::cluster, kDepth stages of
// loads in flight), split once per CTA into tf32 hi and lo planes in a ring
// of two stage buffers, which the wgmma descriptors read directly: no warp
// splits B. The CTAs of a cluster row start on their own rows of B and walk
// the other owners in turn, so each owner serves one peer at a time. A's
// fragments are read from the CTA's own fp32 tile (K, or XR) a stage ahead
// and split per warp. Each run of 16 k, six wgmma (two k-groups, three
// passes) go into a fresh accumulator that one fp32 add takes into the
// total. Each warpgroup stages the half of B's columns that it multiplies,
// so it syncs with itself alone (a named barrier of 128 threads) and the two
// run their stages out of step. A warpgroup's stage: its barrier, the next
// loads issued, its wgmmas issued, then, while they run, the next stage's A
// fragments loaded and its B split into the other ring slot; the wait; the
// adds. K9 keeps no K in shared memory: its A fragments come from ks in
// device memory (L2), which frees the room for stages of 16 rows. A from
// shared memory as well (both wgmma operands staged), and two producer warps
// staging B for two consumer warpgroups through mbarriers, were both slower
// on the card; PERF.md, section 6.
//
// Shared memory (bytes; 64 more for the maxima): K9 <256, 4, 1>: X, T 2 x
// 65,536, ring 2 x 32,768: 196,608. K8 <256, 4, 4>: K, XR 2 x 65,536, X, T
// 2 x 16,384, ring 2 x 16,384: 196,608. K8 <128, 2, 4>: K, XR 2 x 32,768, X,
// T 2 x 8,192, ring 2 x 8,192: 98,304. One CTA an SM.
//
// What bounds them, on an NVIDIA H100 (PERF.md, section 6, gives the
// measured times; probes/plain_phases.py stamps a stage's phases): not the
// tensor cores' rate but a stage's chain of latencies, the wgmma issue
// (~40 clocks a wgmma at n16-n32) and the loads behind it; and for one
// system, the two cluster.sync() of each step.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace qct {

constexpr int PL_THREADS = 256;  // two warpgroups

// One instance: npad kN on a cluster of kR x kC CTAs.
template <int kN, int kR, int kC>
struct PlainShape {
  static constexpr int kCtas = kR * kC;
  static constexpr int kMB = kN / kR;                      // rows of a block
  static constexpr int kNB = kN / kC;                      // columns of a block
  static constexpr int kHalf = kNB / 2;                    // a warpgroup's columns
  static constexpr int kAcc = kNB / 4;                     // its accumulators a thread
  static constexpr bool kKGlobal = kC == 1;                // K read from device memory
  static constexpr int kKB = kC > 1 ? 32 : 16;             // rows of B a stage
  static constexpr int kKG = kKB / 8;                      // wgmma k-groups a stage
  static constexpr int kRuns = kKB / 16;                   // fresh accumulators a stage
  static constexpr int kLoads = kKB * kNB / 1024;          // float4 of B a thread a stage
  static constexpr int kStages = kN / kKB;
  static constexpr int kDepth = kC > 1 ? 4 : 2;            // stages of B loads in flight
  static constexpr int kPlane = kKB * kNB;                 // floats of a stage's hi (lo) plane
  static constexpr int kGather = 16 * kKB * (kC > 1);      // float4 of XR gathered a stage
  static constexpr int kGL = (kGather + PL_THREADS - 1) / PL_THREADS;
  static constexpr int kTileA = kMB * kN;                  // floats of K (and of XR)
  static constexpr int kTileB = kMB * kNB;                 // floats of X and of T
  static constexpr int kFloats = (kKGlobal ? 0 : 2) * kTileA + 2 * kTileB + 4 * kPlane +
                                 16;                       // K, XR, X, T, ring, maxima
  static constexpr size_t kSmemBytes = static_cast<size_t>(kFloats) * sizeof(float);
  static_assert(kMB == 64 && (kHalf == 128 || kHalf == 32 || kHalf == 16) && kLoads >= 1 &&
                    kStages % kDepth == 0 && kMB % kKB == 0,
                "blocks of 64 rows, a wgmma width, whole stages");
};

template <int kHalf>
__device__ __forceinline__ void wgmma_tf32(float (&d)[kHalf / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  if constexpr (kHalf == 128) wgmma_n128(d, a, desc, scale_d);
  if constexpr (kHalf == 32) wgmma_n32(d, a, desc, scale_d);
  if constexpr (kHalf == 16) wgmma_n16(d, a, desc, scale_d);
}

// acc = A @ B for the calling warpgroup's 64 x kHalf half of this CTA's
// block. A (64 x kN) is the CTA's own tile in shared memory or, kAGlobal,
// its 64 rows of ks in device memory (row-major); B (kN x kNB) is the column
// block qj, whose rows [64 i', 64 i' + 64) are the tile at `b_blk` in CTA
// (i', qj). kGatherX: B is X, and XR (64 x kN) receives X's row block qi,
// from the tiles at `b_blk` of CTAs (qi, j'), a few float4 a stage.
template <int kN, int kR, int kC, bool kAGlobal, bool kGatherX>
__device__ __forceinline__ void plain_product(const float* __restrict__ A, const float* b_blk,
                                              float* XR, float* ring,
                                              float (&acc)[PlainShape<kN, kR, kC>::kAcc],
                                              int qi, int qj) {
  using S = PlainShape<kN, kR, kC>;
  const int tid = threadIdx.x, wg = tid >> 7, w4 = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int i = 0; i < S::kAcc; ++i) acc[i] = 0.f;
  const uint32_t b_own = smem_addr(b_blk);
  // B's first row in stage s: this CTA row's own rows first, then the others
  auto row0 = [&](int s) { return (S::kMB * qi + S::kKB * s) % kN; };
  // A stage is one contiguous run of the owner's tile, chunks of 8 rows;
  // each warpgroup stages the half of every chunk that holds its columns
  // (its kHalf / 8 column groups): its float4 u = wt + 128 l sits at float
  // 8 kNB (u / kNB) + 4 kNB wg + 4 (u % kNB) of the run.
  const int wt = tid & 127;
  auto at = [&](int l) {
    const int u = wt + 128 * l;
    return 8 * S::kNB * (u / S::kNB) + 4 * S::kNB * wg + 4 * (u % S::kNB);
  };
  auto load = [&](int s, float4 (&v)[S::kLoads]) {
    const int k0 = row0(s);
    const uint32_t base =
        map_rank(b_own, (k0 / S::kMB) * kC + qj) + 4 * (k0 % S::kMB) * S::kNB;
#pragma unroll
    for (int l = 0; l < S::kLoads; ++l) v[l] = ld_cluster(base + 4 * at(l));
  };
  auto stage = [&](int s, const float4 (&v)[S::kLoads]) {
    float* hi = ring + (s & 1) * 2 * S::kPlane;
#pragma unroll
    for (int l = 0; l < S::kLoads; ++l) {
      uint4 h, o;
      split_tf32(v[l].x, h.x, o.x);
      split_tf32(v[l].y, h.y, o.y);
      split_tf32(v[l].z, h.z, o.z);
      split_tf32(v[l].w, h.w, o.w);
      const int f = at(l);
      *reinterpret_cast<uint4*>(hi + f) = h;
      *reinterpret_cast<uint4*>(hi + S::kPlane + f) = o;
    }
  };
  // A's fragments of stage s, fp32: per k-group a0..a3, rows g, g + 8 of
  // columns t and t + 4 of the warp's 16 rows
  float an[S::kKG][4];
  auto load_a = [&](int s) {
    const int k0 = row0(s);
#pragma unroll
    for (int kg = 0; kg < S::kKG; ++kg)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = 16 * w4 + g + 8 * (f & 1), c = k0 + 8 * kg + t + 4 * (f >> 1);
        an[kg][f] = kAGlobal ? __ldg(A + r * kN + c) : A[blk<kN>(r, c)];
      }
  };
  // stage s's wgmmas, issued: per run of 16 k, six (two k-groups, three
  // passes each) into the fresh accumulator p[run]; A's fragments and p stay
  // put until the wait (wg_hold)
  uint32_t ah[S::kKG][4], al[S::kKG][4];
  float p[S::kRuns][S::kAcc];
  auto issue = [&](int s) {
    // this warpgroup's columns of the stage's planes (bytes)
    const uint32_t hi = smem_addr(ring + (s & 1) * 2 * S::kPlane) + 4 * 64 * (wg * S::kHalf / 8);
    const uint32_t lo = hi + 4 * S::kPlane;
#pragma unroll
    for (int kg = 0; kg < S::kKG; ++kg)
#pragma unroll
      for (int f = 0; f < 4; ++f) split_tf32(an[kg][f], ah[kg][f], al[kg][f]);
    wg_fence();
#pragma unroll
    for (int kg = 0; kg < S::kKG; ++kg) {
      const uint32_t off = 4 * 8 * S::kNB * kg;
      float(&d)[S::kAcc] = p[kg / 2];
      wgmma_tf32<S::kHalf>(d, ah[kg], wg_desc(hi + off), kg & 1);
      wgmma_tf32<S::kHalf>(d, ah[kg], wg_desc(lo + off), 1);
      wgmma_tf32<S::kHalf>(d, al[kg], wg_desc(hi + off), 1);
    }
    wg_commit();
  };
  // XR's float4 f of stage s (4 rows of one column): fi = kGather s + f,
  // from the tile of CTA (qi, column / kNB)
  float4 gv[S::kGL > 0 ? S::kGL : 1];
  auto gather = [&](int s, bool store) {
#pragma unroll
    for (int l = 0; l < S::kGL; ++l) {
      const int f = tid + PL_THREADS * l;
      if (S::kGather % PL_THREADS != 0 && f >= S::kGather) continue;
      const int fi = S::kGather * s + f, rem = fi % (2 * kN), kh = (rem >> 3) & 1;
      const int c = 8 * (rem >> 4) + (rem & 7), cl = c % S::kNB;
      if (store) {
        *reinterpret_cast<float4*>(XR + 4 * fi) = gv[l];
      } else {
        const int src = (fi / (2 * kN)) * 8 * S::kNB + (cl >> 3) * 64 + kh * 32 + (cl & 7) * 4;
        gv[l] = ld_cluster(map_rank(b_own, qi * kC + c / S::kNB) + 4 * src);
      }
    }
  };
  // Stage s: the warpgroup's barrier (its half of the slot stored and fenced
  // for the async proxy; its wgmmas of the slot's previous stage done), stage
  // s + kDepth's loads
  // of B, stage s - 1's gathered float4 stored and stage s's loaded, stage
  // s's wgmmas issued, then, while they run, stage s + 1's A fragments loaded
  // and its B split into the other slot, then the wait and the fp32 adds in k
  // order. Stage x's loads of B are in v[x % kDepth].
  float4 v[S::kDepth][S::kLoads];
#pragma unroll
  for (int d = 0; d < S::kDepth; ++d) load(d, v[d]);
  load_a(0);
  stage(0, v[0]);
  fence_proxy_async();
  for (int s0 = 0; s0 < S::kStages; s0 += S::kDepth) {
#pragma unroll
    for (int d = 0; d < S::kDepth; ++d) {
      const int s = s0 + d;
      wg_bar(wg);
      if (s + S::kDepth < S::kStages) load(s + S::kDepth, v[d]);
      if (kGatherX) {
        if (s > 0) gather(s - 1, true);
        gather(s, false);
      }
      issue(s);
      if (s + 1 < S::kStages) {
        load_a(s + 1);
        stage(s + 1, v[(d + 1) % S::kDepth]);
        fence_proxy_async();
      }
      wg_wait_all();
#pragma unroll
      for (int kg = 0; kg < S::kKG; ++kg)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          wg_hold_r(ah[kg][f]);
          wg_hold_r(al[kg][f]);
        }
#pragma unroll
      for (int ru = 0; ru < S::kRuns; ++ru)
#pragma unroll
        for (int i = 0; i < S::kAcc; ++i) {
          wg_hold_f(p[ru][i]);
          acc[i] += p[ru][i];
        }
    }
  }
  if (kGatherX) gather(S::kStages - 1, true);
}

// ks (b, kN, kN) Jacobi-scaled SPD, identity on the pad -> inv (b, kN, kN):
// `iters` plain fp32 NS steps from I / ||K||_inf. Grid: kR kC CTAs a system,
// one cluster each (launched with the cluster dimension, launch_plain).
template <int kN, int kR, int kC>
__global__ void __launch_bounds__(PL_THREADS, 1)
ns_plain_kernel(const float* __restrict__ ks, float* __restrict__ inv, int iters) {
  using S = PlainShape<kN, kR, kC>;
  extern __shared__ __align__(128) float smem[];
  float* K = smem;
  float* XR = S::kKGlobal ? K : K + S::kTileA;
  float* X = kC > 1 ? XR + S::kTileA : XR;
  float* T = X + S::kTileB;
  float* ring = T + S::kTileB;
  float* maxima = ring + 4 * S::kPlane;  // 8 warps', the CTA's
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank()), qi = q / kC, qj = q % kC;
  const size_t sys = blockIdx.x / S::kCtas;
  const float* krows = ks + sys * kN * kN + static_cast<size_t>(S::kMB * qi) * kN;
  if (!S::kKGlobal) {
    for (int f = threadIdx.x; f < S::kTileA; f += PL_THREADS) K[blk<kN>(f / kN, f % kN)] = krows[f];
  }
  // alpha = 1 / max_i sum_j |K_ij|: this CTA's 64 rows (4 threads a row),
  // then the max over the cluster (the CTAs of a cluster row hold the same
  // rows)
  float row = 0.f;
  for (int c = threadIdx.x & 3; c < kN; c += 4) row += fabsf(krows[(threadIdx.x >> 2) * kN + c]);
  row += __shfl_xor_sync(0xffffffffu, row, 1);
  row += __shfl_xor_sync(0xffffffffu, row, 2);
  const float mx = cta_max(row, maxima);
  if (threadIdx.x == 0) maxima[8] = mx;
  cluster.sync();
  float amax = 0.f;
  for (int p = 0; p < S::kCtas; ++p) amax = fmaxf(amax, *cluster.map_shared_rank(maxima + 8, p));
  const float alpha = 1.f / amax;
  for (int f = threadIdx.x; f < S::kTileB; f += PL_THREADS) {
    const int r = f / S::kNB, c = f % S::kNB;
    X[blk<S::kNB>(r, c)] = (S::kMB * qi + r == S::kNB * qj + c) ? alpha : 0.f;
  }
  cluster.sync();  // K and X complete in every CTA; every peer has read maxima[8]
  // this thread's accumulator i = 4 j + e: row 16 w4 + g + 8 (e / 2), column
  // kHalf wg + 8 j + 2 t + e % 2 of the block
  const int wg = threadIdx.x >> 7, w4 = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  auto at = [&](int i, int& r, int& c) {
    r = 16 * w4 + g + 8 * ((i >> 1) & 1);
    c = S::kHalf * wg + 8 * (i >> 2) + 2 * t + (i & 1);
  };
  float acc[S::kAcc];
  for (int it = 0; it < iters; ++it) {
    plain_product<kN, kR, kC, S::kKGlobal, (kC > 1)>(S::kKGlobal ? krows : K, X, XR, ring, acc,
                                                     qi, qj);
#pragma unroll
    for (int i = 0; i < S::kAcc; ++i) {
      int r, c;
      at(i, r, c);
      const bool diag = S::kMB * qi + r == S::kNB * qj + c;
      T[blk<S::kNB>(r, c)] = (diag ? 2.f : 0.f) - acc[i];
    }
    cluster.sync();  // T complete in every CTA; every read of X (and XR's gather) done
    plain_product<kN, kR, kC, false, false>(XR, T, nullptr, ring, acc, qi, qj);
    __syncthreads();  // this CTA's reads of XR (X itself when kC == 1) are done
#pragma unroll
    for (int i = 0; i < S::kAcc; ++i) {
      int r, c;
      at(i, r, c);
      X[blk<S::kNB>(r, c)] = acc[i];
    }
    cluster.sync();  // X complete in every CTA; every read of T done
  }
  float* out = inv + sys * kN * kN + static_cast<size_t>(S::kMB * qi) * kN + S::kNB * qj;
  for (int f = threadIdx.x; f < S::kTileB; f += PL_THREADS) {
    const int r = f / S::kNB, c = f % S::kNB;
    out[static_cast<size_t>(r) * kN + c] = X[blk<S::kNB>(r, c)];
  }
}

// The launch configuration of an instance for b systems: kR kC CTAs a
// cluster (above 8, the card's non-portable cluster sizes).
template <int kN, int kR, int kC>
cudaError_t plain_config(int b, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                         cudaLaunchAttribute& attr) {
  using S = PlainShape<kN, kR, kC>;
  const auto kernel = ns_plain_kernel<kN, kR, kC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::kSmemBytes));
  if (err == cudaSuccess && S::kCtas > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b * S::kCtas), 1, 1);
  cfg.blockDim = dim3(PL_THREADS, 1, 1);
  cfg.dynamicSmemBytes = S::kSmemBytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = S::kCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

template <int kN, int kR, int kC>
cudaError_t launch_plain(const float* ks, float* inv, int b, int iters, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = plain_config<kN, kR, kC>(b, static_cast<cudaStream_t>(stream), cfg, attr);
  if (err != cudaSuccess || b == 0) return err;
  err = cudaLaunchKernelEx(&cfg, ns_plain_kernel<kN, kR, kC>, ks, inv, iters);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The cluster size of an instance and how many of its clusters the card
// holds at once (0: it cannot place one).
template <int kN, int kR, int kC>
cudaError_t plain_clusters(int* size, int* active) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  *size = kR * kC;
  cudaError_t err = plain_config<kN, kR, kC>(64, nullptr, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(active, ns_plain_kernel<kN, kR, kC>, &cfg);
}

}  // namespace qct

// C entry points (loaded with ctypes). Each returns the launch's cudaError_t;
// the caller checks bounds and types.

// K8: one system (npad 128 or 256) on one cluster.
extern "C" int qct_ns_inverse_plain_one(const float* ks, float* inv, int npad, int iters,
                                        void* stream) {
  if (npad == 128) return static_cast<int>(qct::launch_plain<128, 2, 4>(ks, inv, 1, iters, stream));
  if (npad == 256) return static_cast<int>(qct::launch_plain<256, 4, 4>(ks, inv, 1, iters, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K9 at the 256 tile: b systems, one 4-CTA cluster each.
extern "C" int qct_ns_inverse_plain_256(const float* ks, float* inv, int b, int iters,
                                        void* stream) {
  return static_cast<int>(qct::launch_plain<256, 4, 1>(ks, inv, b, iters, stream));
}

// Instance 0 (K8/128), 1 (K8/256), 2 (K9/256): its cluster size and the
// clusters the card holds at once. For the record in chip_smoke.py.
extern "C" int qct_ns_plain_clusters(int instance, int* size, int* active) {
  switch (instance) {
    case 0: return static_cast<int>(qct::plain_clusters<128, 2, 4>(size, active));
    case 1: return static_cast<int>(qct::plain_clusters<256, 4, 4>(size, active));
    case 2: return static_cast<int>(qct::plain_clusters<256, 4, 1>(size, active));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
