// Probe of what bounds the plain fp32 NS on clusters (csrc/ns_plain.cu) on
// one card, and of the choice of its cluster shapes.
//
//   mkdir -p quadruped_ctrl_tpu_torch/_build
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o quadruped_ctrl_tpu_torch/_build/ns_plain_probe \
//       quadruped_ctrl_tpu_torch/probes/ns_plain_probe.cu
//   quadruped_ctrl_tpu_torch/_build/ns_plain_probe
//
// At cluster sizes 4, 8 and 16, on one cluster alone (K8's case) and on as
// many clusters as the card holds (K9's):
// 1. cluster.sync(): us a barrier over 256 threads a CTA;
// 2. DSMEM pull: each CTA reads its peers' 32 KB buffers with
//    ld.shared::cluster.v4 (8 float4 in flight a thread), GB/s per CTA (a
//    CTA takes 64 KB of shared memory, so a full card holds ~3 an SM);
// 3. DSMEM push: each CTA writes its 32 KB buffer into every peer with
//    cp.async.bulk.shared::cluster (4 KB copies, one thread a peer), the
//    receivers waiting on an mbarrier's transaction count; GB/s per CTA,
//    the round's cluster.sync() taken out;
// 4. L2 for comparison: the CTAs of one cluster read 256 KB each from device
//    memory resident in L2 (ld.global.cg.v4), GB/s per CTA, one CTA an SM.
// 5. The 3xTF32 product loop as mma.sync m16n8k8 from split-once (hi, lo)
//    planes, alone (no DSMEM), one CTA on every SM: us a product for an
//    output of 16 x 256 (row slabs of 16 on 16 CTAs), 64 x 256 (K9's slab),
//    64 x 64 (K8 at 256 on 4 x 4) and 64 x 32 (K8 at 128 on 2 x 4, k = 128),
//    by warp count, order of the mma passes, barrier period and run of k a
//    fresh accumulator takes.
// 6. The wgmma layout (mma.cuh): m64nNk8 tf32 with A from registers and B
//    K-major in shared memory, on small integers (exact in tf32), against
//    the exact product, with the descriptor's leading and stride byte
//    offsets one way (128, 256) and the other.
// 7. The same 64 x 256 x 256 product as wgmma: two warpgroups of m64n128k8,
//    three passes an 8 k into a fresh accumulator, one or two of them in
//    flight.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <vector>

#include "../csrc/mma.cuh"

namespace cg = cooperative_groups;
using namespace qct;

constexpr int kBuf = 32768;  // bytes a CTA serves its peers

// wgmma.wait_group kN: all but the newest kN committed groups done.
template <int kN>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kN) : "memory");
}

// d = a b (m16n8k8 tf32), the accumulator input a zero register: no
// register zeroing before a fresh accumulator's first pass.
__device__ __forceinline__ void mma_tf32_z(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__global__ void __launch_bounds__(256) sync_loop(int rounds, float* out) {
  cg::cluster_group cl = cg::this_cluster();
  for (int i = 0; i < rounds; ++i) cl.sync();
  if (threadIdx.x == 0 && rounds < 0) out[0] = 1.f;
}

__global__ void __launch_bounds__(256) pull(int rounds, float* out) {
  extern __shared__ __align__(128) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int n = static_cast<int>(cl.num_blocks()), q = static_cast<int>(cl.block_rank());
  for (int i = threadIdx.x; i < kBuf / 4; i += 256) sm[i] = i + q;
  cl.sync();
  const uint32_t base = smem_addr(sm);
  float acc = 0.f;
  for (int it = 0; it < rounds; ++it)
    for (int p = 1; p < n; ++p) {
      const uint32_t rb = map_rank(base, (q + p) % n);
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = ld_cluster(rb + (k * 256 + threadIdx.x) * 16);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += v[k].x + v[k].y + v[k].z + v[k].w;
    }
  cl.sync();
  if (acc == 12345.f) out[0] = acc;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void bulk_push(uint32_t dst, uint32_t src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared memory: the source buffer, the receive buffer, the mbarrier.
__global__ void __launch_bounds__(256) push(int rounds, float* out) {
  extern __shared__ __align__(128) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int n = static_cast<int>(cl.num_blocks()), q = static_cast<int>(cl.block_rank());
  const uint32_t src = smem_addr(sm), dst = src + kBuf, bar = src + 2 * kBuf;
  for (int i = threadIdx.x; i < kBuf / 4; i += 256) sm[i] = i + q;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  cl.sync();
  for (int it = 0; it < rounds; ++it) {
    if (threadIdx.x == 0) mbar_expect(bar, (n - 1) * kBuf);
    cl.sync();  // every receiver armed
    if (threadIdx.x < n - 1) {
      const int peer = (q + 1 + static_cast<int>(threadIdx.x)) % n;
      for (int c = 0; c < kBuf; c += 4096)
        bulk_push(map_rank(dst + c, peer), src + c, 4096, map_rank(bar, peer));
    }
    for (int spin = 0; !mbar_try(bar, it & 1); ++spin) {
      if (spin > (1 << 22)) {  // a push that never lands: report it, do not hang
        out[1] = 1.f;
        break;
      }
    }
  }
  cl.sync();
  if (rounds < 0) out[0] = sm[kBuf / 4];
}

__global__ void __launch_bounds__(256) l2_read(const float4* src, int rounds, float* out) {
  const int q = blockIdx.x;
  float acc = 0.f;
  for (int it = 0; it < rounds; ++it)
    for (int k = 0; k < 256 * 1024 / 16 / 256; k += 8) {
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __ldcg(src + (q * 16 + (k + j)) * 256 + threadIdx.x);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += v[j].x + v[j].y + v[j].z + v[j].w;
    }
  if (acc == 12345.f) out[0] = acc;
}

// The 3xTF32 product loop on an MB x NB output block, k = N, from (hi, lo)
// planes of B in a ring of two 8-row stages (not restaged: the operands'
// values do not matter here). kWarps warps in MB / 32 warp rows (MB = 16:
// one row of 16-row tiles); kOrder 0: each tile's three passes in turn into
// its fresh accumulator, 1: one pass over every tile, then the next, 2: as 0
// with the first pass's accumulator input a zero register, 3: as 2 with a
// run of 16 k a fresh accumulator; a __syncthreads every kSync k (0: none).
template <int N, int MB, int NB, int kWarps, int kOrder, int kSync>
__global__ void __launch_bounds__(kWarps * 32, 1) product(int reps, float* out) {
  constexpr int MT = MB >= 32 ? 2 : 1, WROWS = MB / (16 * MT), WCOLS = kWarps / WROWS;
  constexpr int WN = NB / WCOLS, NT = WN / 8, PS = NB + 4;
  extern __shared__ __align__(128) float sm[];
  float* A = sm;
  uint2* ring = reinterpret_cast<uint2*>(sm + MB * N);
  for (int i = threadIdx.x; i < MB * N; i += kWarps * 32) A[i] = 1.f + 1e-3f * (i % 97);
  for (int i = threadIdx.x; i < 2 * 8 * PS; i += kWarps * 32) {
    uint32_t h, l;
    split_tf32(0.5f + 1e-3f * (i % 89), h, l);
    ring[i] = make_uint2(h, l);
  }
  __syncthreads();
  const int tid = threadIdx.x, g = (tid & 31) >> 2, t = tid & 3;
  const int wm = (tid >> 5) / WCOLS, wn = (tid >> 5) % WCOLS;
  float acc[MT][NT][4] = {};
  for (int rep = 0; rep < reps; ++rep)
    for (int k0 = 0; k0 < N; k0 += 8) {
      const uint2* slot = ring + ((k0 >> 3) & 1) * 8 * PS;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int r = 16 * MT * wm + 16 * mt + g + 8 * (f & 1);
          const int c = k0 + t + 4 * (f >> 1);
          split_tf32(A[r * N + (c ^ ((r & 7) << 2))], ah[mt][f], al[mt][f]);
        }
      if (kOrder == 2 || kOrder == 3) {  // zero-C first pass; kOrder 3: runs of 16 k
        uint32_t bh[MT][4], bl[MT][4];  // the second 8 k's A fragments (kOrder 3)
        if (kOrder == 3) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              const int r = 16 * MT * wm + 16 * mt + g + 8 * (f & 1);
              const int c = k0 + 8 + t + 4 * (f >> 1);
              split_tf32(A[r * N + (c ^ ((r & 7) << 2))], bh[mt][f], bl[mt][f]);
            }
        }
        const uint2* slot2 = ring + (((k0 >> 3) + 1) & 1) * 8 * PS;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = WN * wn + 8 * nt + g;
          const uint2 b0 = slot[t * PS + n], b1 = slot[(t + 4) * PS + n];
          uint2 c0, c1;
          if (kOrder == 3) {
            c0 = slot2[t * PS + n];
            c1 = slot2[(t + 4) * PS + n];
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float p[4];
            mma_tf32_z(p, ah[mt], b0.x, b1.x);
            mma_tf32(p, ah[mt], b0.y, b1.y);
            mma_tf32(p, al[mt], b0.x, b1.x);
            if (kOrder == 3) {
              mma_tf32(p, bh[mt], c0.x, c1.x);
              mma_tf32(p, bh[mt], c0.y, c1.y);
              mma_tf32(p, bl[mt], c0.x, c1.x);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];
          }
        }
        if (kOrder == 3) k0 += 8;
      } else if (kOrder == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = WN * wn + 8 * nt + g;
          const uint2 b0 = slot[t * PS + n], b1 = slot[(t + 4) * PS + n];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float p[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(p, ah[mt], b0.x, b1.x);
            mma_tf32(p, ah[mt], b0.y, b1.y);
            mma_tf32(p, al[mt], b0.x, b1.x);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];
          }
        }
      } else {
        uint2 b0[NT], b1[NT];
        float p[MT][NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = WN * wn + 8 * nt + g;
          b0[nt] = slot[t * PS + n];
          b1[nt] = slot[(t + 4) * PS + n];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) p[mt][nt][e] = 0.f;
            mma_tf32(p[mt][nt], ah[mt], b0[nt].x, b1[nt].x);
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_tf32(p[mt][nt], ah[mt], b0[nt].y, b1[nt].y);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_tf32(p[mt][nt], al[mt], b0[nt].x, b1[nt].x);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[mt][nt][e];
      }
      if (kSync && (k0 + 8) % kSync == 0) __syncthreads();
    }
  float s = 0.f;
  for (int mt = 0; mt < MT; ++mt)
    for (int nt = 0; nt < NT; ++nt)
      for (int e = 0; e < 4; ++e) s += acc[mt][nt][e];
  if (s == 12345.f) out[0] = s;
}


// 6. The wgmma layout: one warpgroup, D (64 x N) = A (64 x 8) B (8 x N) of
// small integers (exact in tf32), B stored as (k, n) at (n / 8) 256 + (k / 4)
// 128 + (n % 8) 16 + (k % 4) 4 bytes; descriptor (lbo, sbo) as given.
template <int N>
__global__ void __launch_bounds__(128) wgmma_check(const float* A, const float* B, float* D,
                                                   int lbo, int sbo) {
  __shared__ __align__(128) float bs[8 * N];
  for (int i = threadIdx.x; i < 8 * N; i += 128) {
    const int k = i / N, n = i % N;
    bs[(n / 8) * 64 + (k / 4) * 32 + (n % 8) * 4 + (k % 4)] = B[i];
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  uint32_t a[4];
  for (int f = 0; f < 4; ++f)
    a[f] = __float_as_uint(A[(16 * w + g + 8 * (f & 1)) * 8 + t + 4 * (f >> 1)]);
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const uint64_t desc = wg_desc(smem_addr(bs), lbo, sbo);
  wg_fence();
  if constexpr (N == 128) wgmma_n128(d, a, desc, 0);
  if constexpr (N == 32) wgmma_n32(d, a, desc, 0);
  if constexpr (N == 16) wgmma_n16(d, a, desc, 0);
  wg_commit();
  wg_wait<0>();
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e)
      D[(16 * w + g + 8 * (e >> 1)) * N + 8 * j + 2 * t + (e & 1)] = d[4 * j + e];
}

// 7. The 3xTF32 product with wgmma: two warpgroups, each the m64 x 128 half
// of a 64 x 256 output, k = 256 from (hi, lo) planes of an 8-row stage in the
// K-major layout above (not restaged); per 8 k three wgmma into a fresh
// accumulator that one fp32 add takes into the total. kDouble: two fresh
// accumulators, the add of stage s - 1 after stage s's wgmmas are issued.
template <bool kDouble>
__global__ void __launch_bounds__(256, 1) wgmma_rate(int reps, float* out) {
  extern __shared__ __align__(128) float sm[];
  float* A = sm;                          // 64 x 256 fp32, row-major
  float* planes = sm + 64 * 256;          // 2 stages x (hi, lo) x 256 n x 8 k
  for (int i = threadIdx.x; i < 64 * 256; i += 256) A[i] = 1.f + 1e-3f * (i % 97);
  for (int i = threadIdx.x; i < 2 * 2 * 2048; i += 256) {
    uint32_t h, l;
    split_tf32(0.5f + 1e-3f * (i % 89), h, l);
    planes[i] = __uint_as_float(i & 2048 ? l : h);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  float acc[64] = {}, p0[64], p1[64];
  const uint32_t base = smem_addr(planes) + wg * 16 * 256;  // this warpgroup's 16 n-groups
  // stage s into p; then, kDouble, the add of q (stage s - 1's), else of p
  auto stage = [&](int s, float (&p)[64], float (&q)[64]) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int f = 0; f < 4; ++f)
      split_tf32(A[(16 * w + g + 8 * (f & 1)) * 256 + 8 * s + t + 4 * (f >> 1)], ah[f], al[f]);
    const uint32_t hi = base + (s & 1) * 16384, lo = hi + 8192;
    wg_fence();
    wgmma_n128(p, ah, wg_desc(hi, 128, 256), 0);
    wgmma_n128(p, ah, wg_desc(lo, 128, 256), 1);
    wgmma_n128(p, al, wg_desc(hi, 128, 256), 1);
    wg_commit();
    if (kDouble) {
      wg_wait<1>();
      if (s > 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += q[i];
      }
    } else {
      wg_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += p[i];
    }
  };
  for (int rep = 0; rep < reps; ++rep) {
    for (int s = 0; s < 32; s += 2) {
      stage(s, p0, p1);
      stage(s + 1, p1, p0);
    }
    if (kDouble) {
      wg_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += p1[i];
    }
  }
  float sum = 0.f;
  for (int i = 0; i < 64; ++i) sum += acc[i];
  if (sum == 12345.f) out[0] = sum;
}

static cudaEvent_t e0, e1;

template <typename Launch>
static float time_ms(Launch launch) {
  launch(true);
  cudaEventRecord(e0);
  launch(false);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}

template <typename... Args>
static cudaError_t launch_cluster(void (*kernel)(Args...), int clusters, int size, size_t smem,
                                  Args... args) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  if (size > 8) cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * size, 1, 1);
  cfg.blockDim = dim3(256, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = size;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename... Args>
static int max_clusters(void (*kernel)(Args...), int size, size_t smem) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  if (size > 8) cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size * 64, 1, 1);
  cfg.blockDim = dim3(256, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = size;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return n;
}

template <int N, int MB, int NB, int kWarps, int kOrder, int kSync>
static void product_line(float* out, int sms) {
  const size_t smem = (MB * N + 2 * 8 * (NB + 4) * 2) * sizeof(float);
  const auto kernel = product<N, MB, NB, kWarps, kOrder, kSync>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int reps = 200;
  const float ms = time_ms([&](bool warm) {
    kernel<<<sms, kWarps * 32, smem>>>(warm ? 2 : reps, out);
  });
  const double mma = 3.0 * MB * NB * N / (16 * 8 * 8);
  printf("product %3d x %3d, k = %3d, %2d warps, %s, sync every %2d k: %.3f us a product a CTA, "
         "%.0f m16n8k8 mma, %.1f TFLOP/s over %d SMs [%s]\n",
         MB, NB, N, kWarps,
         kOrder == 0 ? "tile-major" : kOrder == 1 ? "pass-major" : kOrder == 2 ? "zero-C 8-k runs"
                                                                            : "zero-C 16-k runs",
         kSync, ms * 1e3 / reps, mma,
         2.0 * 1024 * mma * reps * sms / (ms * 1e-3) / 1e12, sms,
         cudaGetErrorString(cudaGetLastError()));
}

template <int N>
static void wgmma_layout() {
  std::vector<float> a(64 * 8), b(8 * N), d(64 * N);
  for (int i = 0; i < 64; ++i)
    for (int k = 0; k < 8; ++k) a[i * 8 + k] = static_cast<float>((i * 3 + k * 5) % 7 - 3);
  for (int k = 0; k < 8; ++k)
    for (int n = 0; n < N; ++n) b[k * N + n] = static_cast<float>((k * 11 + n * 13) % 9 - 4);
  float *da, *db, *dd;
  cudaMalloc(&da, a.size() * 4);
  cudaMalloc(&db, b.size() * 4);
  cudaMalloc(&dd, d.size() * 4);
  cudaMemcpy(da, a.data(), a.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(db, b.data(), b.size() * 4, cudaMemcpyHostToDevice);
  for (int swap = 0; swap < 2; ++swap) {
    cudaMemset(dd, 0, d.size() * 4);
    wgmma_check<N><<<1, 128>>>(da, db, dd, swap ? 256 : 128, swap ? 128 : 256);
    cudaMemcpy(d.data(), dd, d.size() * 4, cudaMemcpyDeviceToHost);
    double worst = 0.0;
    for (int i = 0; i < 64; ++i)
      for (int n = 0; n < N; ++n) {
        double exact = 0.0;
        for (int k = 0; k < 8; ++k) exact += static_cast<double>(a[i * 8 + k]) * b[k * N + n];
        worst = std::fmax(worst, std::fabs(d[i * N + n] - exact));
      }
    printf("wgmma m64n%dk8 layout, lbo %d sbo %d: max |D - D_exact| %.3e [%s]\n", N,
           swap ? 256 : 128, swap ? 128 : 256, worst, cudaGetErrorString(cudaGetLastError()));
  }
  cudaFree(da);
  cudaFree(db);
  cudaFree(dd);
}

int main() {
  cudaDeviceProp pr;
  cudaGetDeviceProperties(&pr, 0);
  printf("%s, %d SMs, %d kHz\n", pr.name, pr.multiProcessorCount, pr.clockRate);
  float* out;
  cudaMalloc(&out, 8);
  cudaMemset(out, 0, 8);
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const size_t buf_smem = 2 * kBuf + 64;
  for (int size : {4, 8, 16}) {
    const int full = max_clusters(pull, size, buf_smem);
    for (int clusters : {1, full}) {
      const int rounds = 2000;
      const float sync_ms = time_ms([&](bool warm) {
        launch_cluster(sync_loop, clusters, size, 0, warm ? 10 : rounds, out);
      });
      const float pull_ms = time_ms([&](bool warm) {
        launch_cluster(pull, clusters, size, buf_smem, warm ? 2 : 200, out);
      });
      const float push_ms = time_ms([&](bool warm) {
        launch_cluster(push, clusters, size, buf_smem, warm ? 2 : 200, out);
      });
      float lost = 0.f;
      cudaMemcpy(&lost, out + 1, 4, cudaMemcpyDeviceToHost);
      const double sync_us = sync_ms * 1e3 / rounds, bytes = (size - 1.0) * kBuf;
      const double push_us = push_ms * 1e3 / 200 - sync_us;
      printf("cluster %2d x %3d clusters: cluster.sync %.3f us; DSMEM pull %.1f GB/s per CTA "
             "(%.2f us per %.0f KB); push %.1f GB/s per CTA (%.2f us per %.0f KB)%s [%s]\n",
             size, clusters, sync_us, bytes / (pull_ms * 1e-3 / 200) / 1e9,
             pull_ms * 1e3 / 200, bytes / 1024, bytes / (push_us * 1e-6) / 1e9, push_us,
             bytes / 1024, lost != 0.f ? " (a push never landed)" : "",
             cudaGetErrorString(cudaGetLastError()));
    }
  }
  float4* l2;
  cudaMalloc(&l2, 16 << 20);
  cudaMemset(l2, 0, 16 << 20);
  for (int ctas : {8, 16, pr.multiProcessorCount}) {
    const int rounds = 50;
    const float ms = time_ms([&](bool warm) {
      l2_read<<<ctas, 256>>>(l2, warm ? 2 : rounds, out);
    });
    printf("L2 read, %3d CTAs: %.1f GB/s per CTA (%.2f us per 256 KB) [%s]\n", ctas,
           256.0 * 1024 * rounds / (ms * 1e-3) / 1e9, ms * 1e3 / rounds,
           cudaGetErrorString(cudaGetLastError()));
  }
  const int sms = pr.multiProcessorCount;
  product_line<256, 16, 256, 8, 0, 8>(out, sms);
  product_line<256, 64, 256, 8, 0, 8>(out, sms);
  product_line<256, 64, 256, 8, 0, 0>(out, sms);
  product_line<256, 64, 256, 8, 1, 0>(out, sms);
  product_line<256, 64, 256, 8, 3, 0>(out, sms);
  product_line<256, 64, 256, 16, 1, 0>(out, sms);
  product_line<256, 64, 64, 8, 0, 8>(out, sms);
  product_line<256, 64, 64, 8, 3, 0>(out, sms);
  product_line<128, 64, 32, 8, 0, 8>(out, sms);
  product_line<128, 64, 32, 8, 3, 0>(out, sms);
  wgmma_layout<128>();
  wgmma_layout<32>();
  wgmma_layout<16>();
  for (int dbl = 0; dbl < 2; ++dbl) {
    const size_t smem = (64 * 256 + 2 * 2 * 2048) * sizeof(float);
    const auto kernel = dbl ? wgmma_rate<true> : wgmma_rate<false>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    const int reps = 200;
    const float ms = time_ms([&](bool warm) { kernel<<<sms, 256, smem>>>(warm ? 2 : reps, out); });
    printf("wgmma 3xTF32 product 64 x 256, k = 256, %s: %.3f us a product a CTA, %.1f TFLOP/s "
           "over %d SMs [%s]\n",
           dbl ? "two fresh accumulators" : "one fresh accumulator", ms * 1e3 / reps,
           2.0 * 3 * 64 * 256 * 256 * reps * sms / (ms * 1e-3) / 1e12, sms,
           cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
