// Probe of the two ways a 4-CTA cluster can move B's rows between its CTAs'
// shared memory at the 256 tile (csrc/ns_refine.cu), on one card, as many
// clusters as it holds (one CTA an SM, 229,376 bytes of shared memory each):
//
//   mkdir -p quadruped_ctrl_tpu_torch/_build
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o quadruped_ctrl_tpu_torch/_build/dsmem_push_probe \
//       quadruped_ctrl_tpu_torch/probes/dsmem_push_probe.cu
//   quadruped_ctrl_tpu_torch/_build/dsmem_push_probe
//
// Every CTA holds a 64 KB slab (its rows of B) and a landing area of one
// 16 KB slot per peer. A step moves a 16 KB piece of each CTA's slab into
// its slot in each of the 3 peers (48 KB into every CTA), then
// cluster.sync(); 4 steps move the whole slab, as a product's remote B does.
//
//   pull       every thread loads its 12 float4 of the 3 peers' pieces by
//              ld.shared::cluster.v4, all in flight, and stores them in the
//              landing slots (what ns_refine.cu's rf_product does, split
//              aside)
//   push       the owner's thread 0 pushes each piece with one
//              cp.async.bulk.shared::cluster.shared::cta (16 KB), completing
//              on the receiving CTA's mbarrier, whose threads wait on it
//   push 4 KB  the same in 4 copies of 4 KB a piece (a stage's size)
//   push+read  push, then every thread reads its 12 float4 of the landed
//              48 KB from its own shared memory (what a consumer that
//              splits B into bf16 planes would still do)
//
// Printed: GB/s received a CTA and us a step. The lines say which route a
// design of the step should take; the step itself is not changed by it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kPiece = 16384;     // bytes of one peer's piece a step
constexpr int kSlab = 65536;      // bytes of a CTA's rows
constexpr size_t kSmem = 229376;  // as ns_refine_kernel<256, ·>: one CTA an SM

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes from this CTA's shared memory (src) to a peer's (dst, a
// shared::cluster address), completing on the peer's mbarrier (bar, the same).
__device__ __forceinline__ void bulk_push(uint32_t dst, uint32_t src, unsigned bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// kMode 0 pull, 1 push, 2 push in 4 KB copies, 3 push then read locally
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1) move_pieces(int steps, float* out) {
  extern __shared__ __align__(128) char smem[];
  char* slab = smem;
  char* land = smem + kSlab;                                        // 4 slots, by sender's rank
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kSlab + 4 * kPiece);
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank()), tid = threadIdx.x;
  for (int i = tid; i < kSlab / 4; i += kThreads)
    reinterpret_cast<float*>(slab)[i] = static_cast<float>(i % 97);
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  cluster.sync();
  float acc = 0.f;
  for (int t = 0; t < steps; ++t) {
    const int piece = (t & 3) * kPiece;
    if constexpr (kMode == 0) {
      float4 v[3][kPiece / 16 / kThreads];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int i = 0; i < kPiece / 16 / kThreads; ++i)
          v[j][i] = ld_cluster(mapa(smem_u32(slab + piece + 16 * (tid + kThreads * i)),
                                    (q + 1 + j) & 3));
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int i = 0; i < kPiece / 16 / kThreads; ++i)
          reinterpret_cast<float4*>(land + ((q + 1 + j) & 3) * kPiece)[tid + kThreads * i] =
              v[j][i];
    } else {
      if (tid == 0) {
        mbar_expect_tx(bar, 3 * kPiece);
        constexpr int kCopy = kMode == 2 ? 4096 : kPiece;
        for (int j = 1; j < 4; ++j) {
          const int p = (q + j) & 3;
          for (int c = 0; c < kPiece; c += kCopy)
            bulk_push(mapa(smem_u32(land + q * kPiece + c), p), smem_u32(slab + piece + c), kCopy,
                      mapa(smem_u32(bar), p));
        }
      }
      mbar_wait(bar, t & 1);
      if constexpr (kMode == 3) {
#pragma unroll
        for (int j = 1; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < kPiece / 16 / kThreads; ++i) {
            const float4 v =
                reinterpret_cast<const float4*>(land + ((q + j) & 3) * kPiece)[tid + kThreads * i];
            acc += v.x + v.y + v.z + v.w;
          }
      }
    }
    cluster.sync();  // every landing slot read; the next step may refill it
  }
  acc += reinterpret_cast<const float*>(land)[tid];
  if (acc == 12345.f) out[0] = acc;
}

static cudaEvent_t e0, e1;

template <int kMode>
static void line(const char* name, float* out) {
  const auto kernel = move_pieces<kMode>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(kSmem));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(4 * 64, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
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
  const int steps = 2000;
  cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, 8, out);  // warm-up
  cudaEventRecord(e0);
  if (rc == cudaSuccess) rc = cudaLaunchKernelEx(&cfg, kernel, steps, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double bytes = 3.0 * kPiece * steps;  // received a CTA
  printf("%-10s %d clusters of 4: %.1f GB/s received a CTA, %.3f us a step of 48 KB [%s, %s]\n",
         name, clusters, bytes / (ms * 1e-3) / 1e9, ms * 1e3 / steps, cudaGetErrorString(rc),
         cudaGetErrorString(cudaDeviceSynchronize()));
}

int main() {
  cudaDeviceProp pr;
  cudaGetDeviceProperties(&pr, 0);
  printf("%s, %d SMs, %d kHz\n", pr.name, pr.multiProcessorCount, pr.clockRate);
  float* out;
  cudaMalloc(&out, 8);
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int r = 0; r < 2; ++r) {
    line<0>("pull", out);
    line<1>("push", out);
    line<2>("push 4 KB", out);
    line<3>("push+read", out);
  }
  return 0;
}
