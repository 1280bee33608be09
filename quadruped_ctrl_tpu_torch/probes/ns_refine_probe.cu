// Probe of the warm Newton-Schulz refinement's pieces (csrc/ns_refine.cu) on
// one card.
//
//   mkdir -p quadruped_ctrl_tpu_torch/_build
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o quadruped_ctrl_tpu_torch/_build/ns_refine_probe \
//       quadruped_ctrl_tpu_torch/probes/ns_refine_probe.cu
//   quadruped_ctrl_tpu_torch/_build/ns_refine_probe
//
// 1. The bf16 wgmma layout (mma.cuh, wgmma_bf16_n128): m64n128k16 with A
//    from registers in the m16n8k16 fragment layout and B K-major in shared
//    memory, on small integers (exact in bf16), against the exact product,
//    with the descriptor's leading and stride byte offsets one way (128,
//    256) and the other.
// 2. The product alone, one CTA of two warpgroups on every SM, each
//    warpgroup a 64 x 128 output over k = 128 (the 128 tile's product, 128 x
//    128 x 128 a CTA) or k = 256 (the 256 tile's, 64 x 256 x 256 a CTA):
//    bf16x3 (three m64n128k16 a 16 k into one accumulator) and 3xTF32 (three
//    m64n128k8 an 8 k into a fresh accumulator added every 16 k), A's
//    fragments read from an fp32 tile in blk layout and split per warp as
//    the kernel does, B from one stage of split planes (not restaged), a
//    wait every 16 k: us a product a CTA and TFLOP/s over the SMs.
// 3. The staging route at 256: 4-CTA clusters of 229,376 bytes of shared
//    memory a CTA (one an SM), as many as the card holds, each CTA reading
//    its three peers' 64 KB slabs over DSMEM (ld.shared::cluster.v4, 8 float4
//    in flight a thread), against reading the same 192 KB from device memory
//    resident in L2 (ld.global.cg.v4): GB/s a CTA.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <vector>

#include "../csrc/mma.cuh"

namespace cg = cooperative_groups;
using namespace qct;

// 1. One warpgroup: D (64 x 128) = A (64 x 16) B (16 x 128), B stored as
// (k, n) at (n / 8) 256 + (k / 8) 128 + (n % 8) 16 + (k % 8) 2 bytes;
// descriptor (lbo, sbo) as given.
__global__ void __launch_bounds__(128) bf16_check(const float* A, const float* B, float* D,
                                                  int lbo, int sbo) {
  __shared__ __align__(128) __nv_bfloat16 bs[16 * 128];
  for (int i = threadIdx.x; i < 16 * 128; i += 128) {
    const int k = i / 128, n = i % 128;
    bs[(n / 8) * 128 + (k / 8) * 64 + (n % 8) * 8 + (k % 8)] = __float2bfloat16_rn(B[i]);
  }
  fence_proxy_async();
  __syncthreads();
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  uint32_t a[4];
  for (int f = 0; f < 4; ++f) {
    const int r = 16 * w + g + 8 * (f & 1), c = 2 * t + 8 * (f >> 1);
    a[f] = bits(__floats2bfloat162_rn(A[r * 16 + c], A[r * 16 + c + 1]));
  }
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  wg_fence();
  wgmma_bf16_n128(d, a, wg_desc(smem_addr(bs), lbo, sbo), 0);
  wg_commit();
  wg_wait_all();
  for (int j = 0; j < 16; ++j)
    for (int e = 0; e < 4; ++e)
      D[(16 * w + g + 8 * (e >> 1)) * 128 + 8 * j + 2 * t + (e & 1)] = d[4 * j + e];
}

// 2. Each warpgroup: acc (64 x 128) = A (64 x kK) B (kK x 128) per rep.
template <bool kBf16, int kK>
__global__ void __launch_bounds__(256, 1) product_rate(int reps, float* out) {
  extern __shared__ __align__(128) float sm[];
  float* A = sm;                          // 2 warpgroups x 64 x kK fp32, blk<kK>
  float* planes = sm + 2 * 64 * kK;       // one stage: hi and lo planes, 2 x 4,096 floats
  for (int i = threadIdx.x; i < 2 * 64 * kK; i += 256) A[i] = 1.f + 1e-3f * (i % 97);
  for (int i = threadIdx.x; i < 8192; i += 256) {
    uint32_t h, l;
    split_tf32(0.5f + 1e-3f * (i % 89), h, l);
    planes[i] = __uint_as_float(i < 4096 ? h : l);
  }
  fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const float* Aw = A + wg * 64 * kK;
  const uint32_t hi = smem_addr(planes) + wg * 16 * 256, lo = hi + 4 * 4096;
  float acc[64] = {}, p[64];
  for (int rep = 0; rep < reps; ++rep) {
    for (int k0 = 0; k0 < kK; k0 += 16) {
      uint32_t ah[2][4], al[2][4];
      for (int kg = 0; kg < 2; ++kg)
        for (int f = 0; f < 4; ++f) {
          const int r = 16 * w + g + 8 * (f & 1);
          if (kBf16) {
            if (kg == 0) {
              const int c = k0 + 2 * t + 8 * (f >> 1);
              split_pair(Aw[blk<kK>(r, c)], Aw[blk<kK>(r, c + 1)], ah[0][f], al[0][f]);
            }
          } else {
            split_tf32(Aw[blk<kK>(r, k0 + 8 * kg + t + 4 * (f >> 1))], ah[kg][f], al[kg][f]);
          }
        }
      wg_fence();
      if (kBf16) {
        wgmma_bf16_n128(acc, ah[0], wg_desc(hi), 1);
        wgmma_bf16_n128(acc, ah[0], wg_desc(lo), 1);
        wgmma_bf16_n128(acc, al[0], wg_desc(hi), 1);
      } else {
        for (int kg = 0; kg < 2; ++kg) {
          wgmma_n128(p, ah[kg], wg_desc(hi + kg * 8192), kg);
          wgmma_n128(p, ah[kg], wg_desc(lo + kg * 8192), 1);
          wgmma_n128(p, al[kg], wg_desc(hi + kg * 8192), 1);
        }
      }
      wg_commit();
      wg_wait_all();
      for (int kg = 0; kg < 2; ++kg)
        for (int f = 0; f < 4; ++f) {
          wg_hold_r(ah[kg][f]);
          wg_hold_r(al[kg][f]);
        }
      for (int i = 0; i < 64; ++i) {
        if (kBf16) {
          wg_hold_f(acc[i]);
        } else {
          wg_hold_f(p[i]);
          acc[i] += p[i];
        }
      }
    }
  }
  float sum = 0.f;
  for (int i = 0; i < 64; ++i) sum += acc[i];
  if (sum == 12345.f) out[0] = sum;
}

// A float4 of device memory through L2 (volatile: a round's reads are not
// hoisted out of the probe's loop).
__device__ __forceinline__ float4 ld_l2(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// 3. Each CTA reads its three peers' 64 KB slabs (kL2: the same bytes from
// the cluster's 256 KB in device memory), 8 float4 in flight a thread. The
// addresses move with the round: identical loads in a loop are hoisted out
// of it by the assembler, asm volatile or not.
template <bool kL2>
__global__ void __launch_bounds__(256, 1) slab_pull(const float4* src, int rounds, float* out) {
  extern __shared__ __align__(128) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int q = static_cast<int>(cl.block_rank());
  for (int i = threadIdx.x; i < 16384; i += 256) sm[i] = static_cast<float>(i + q);
  cl.sync();
  const float4* mine = src + (blockIdx.x / 4) * 16384;  // the cluster's 256 KB
  const uint32_t base = smem_addr(sm);
  float acc = 0.f;
  for (int it = 0; it < rounds; ++it) {
    for (int pp = 1; pp < 4; ++pp) {
      const int peer = (q + pp) & 3;
      const uint32_t remote = map_rank(base, peer);
      for (int f0 = 0; f0 < 4096; f0 += 8 * 256) {
        float4 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // rotated by the round, so that no round's loads repeat the last's
          const int f = (f0 + j * 256 + threadIdx.x + 32 * it) & 4095;
          if (kL2) {
            v[j] = ld_l2(mine + peer * 4096 + f);
          } else {
            v[j] = ld_cluster(remote + 16 * f);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc += v[j].x + v[j].y + v[j].z + v[j].w;
      }
    }
  }
  cl.sync();
  if (acc == 12345.f) out[0] = acc;
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

static void bf16_layout() {
  std::vector<float> a(64 * 16), b(16 * 128), d(64 * 128);
  for (int i = 0; i < 64; ++i)
    for (int k = 0; k < 16; ++k) a[i * 16 + k] = static_cast<float>((i * 3 + k * 5) % 7 - 3);
  for (int k = 0; k < 16; ++k)
    for (int n = 0; n < 128; ++n) b[k * 128 + n] = static_cast<float>((k * 11 + n * 13) % 9 - 4);
  float *da, *db, *dd;
  cudaMalloc(&da, a.size() * 4);
  cudaMalloc(&db, b.size() * 4);
  cudaMalloc(&dd, d.size() * 4);
  cudaMemcpy(da, a.data(), a.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(db, b.data(), b.size() * 4, cudaMemcpyHostToDevice);
  for (int swap = 0; swap < 2; ++swap) {
    cudaMemset(dd, 0, d.size() * 4);
    bf16_check<<<1, 128>>>(da, db, dd, swap ? 256 : 128, swap ? 128 : 256);
    cudaMemcpy(d.data(), dd, d.size() * 4, cudaMemcpyDeviceToHost);
    double worst = 0.0;
    for (int i = 0; i < 64; ++i)
      for (int n = 0; n < 128; ++n) {
        double exact = 0.0;
        for (int k = 0; k < 16; ++k) exact += static_cast<double>(a[i * 16 + k]) * b[k * 128 + n];
        worst = std::fmax(worst, std::fabs(d[i * 128 + n] - exact));
      }
    printf("wgmma m64n128k16 bf16 layout, lbo %d sbo %d: max |D - D_exact| %.3e [%s]\n",
           swap ? 256 : 128, swap ? 128 : 256, worst, cudaGetErrorString(cudaGetLastError()));
  }
  cudaFree(da);
  cudaFree(db);
  cudaFree(dd);
}

template <bool kBf16, int kK>
static void product_line(float* out, int sms) {
  const size_t smem = (2 * 64 * kK + 8192) * sizeof(float);
  const auto kernel = product_rate<kBf16, kK>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int reps = 200;
  const float ms = time_ms([&](bool warm) { kernel<<<sms, 256, smem>>>(warm ? 2 : reps, out); });
  const double flop = 2.0 * 3 * 128 * 128 * kK;  // a CTA's product: 2 warpgroups of 64 x 128 x kK
  printf("product %s, a CTA %s: %.3f us a product a CTA, %.1f TFLOP/s over %d SMs [%s]\n",
         kBf16 ? "bf16x3" : "3xTF32", kK == 128 ? "128 x 128 x 128" : "64 x 256 x 256",
         ms * 1e3 / reps, flop * reps * sms / (ms * 1e-3) / 1e12, sms,
         cudaGetErrorString(cudaGetLastError()));
}

template <bool kL2>
static void pull_line(const float4* src, float* out) {
  const size_t smem = 229376;
  const auto kernel = slab_pull<kL2>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(4 * 64, 1, 1);
  cfg.blockDim = dim3(256, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 4;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  cfg.gridDim = dim3(4 * clusters, 1, 1);
  const int rounds = 50;
  cudaError_t rc = cudaSuccess;
  const float ms = time_ms([&](bool warm) {
    const cudaError_t r = cudaLaunchKernelEx(&cfg, kernel, src, warm ? 2 : rounds, out);
    if (r != cudaSuccess) rc = r;
  });
  const double bytes = 3.0 * 65536 * rounds;
  printf("slab pull at 256, %d clusters of 4: %s %.1f GB/s a CTA (%.2f us per 192 KB) [%s, %s]\n",
         clusters, kL2 ? "L2" : "DSMEM", bytes / (ms * 1e-3) / 1e9, ms * 1e3 / rounds,
         cudaGetErrorString(rc), cudaGetErrorString(cudaDeviceSynchronize()));
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
  bf16_layout();
  const int sms = pr.multiProcessorCount;
  product_line<true, 128>(out, sms);
  product_line<false, 128>(out, sms);
  product_line<true, 256>(out, sms);
  product_line<false, 256>(out, sms);
  float4* src;
  cudaMalloc(&src, 64 * 262144);
  cudaMemset(src, 0, 64 * 262144);
  for (int i = 0; i < 2; ++i) {
    pull_line<false>(src, out);
    pull_line<true>(src, out);
  }
  return 0;
}
