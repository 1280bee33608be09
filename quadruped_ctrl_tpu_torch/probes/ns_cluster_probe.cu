// Probe of what bounded the 256-tile NS product of the former csrc/ns_cluster.cu
// (mma.sync, a cluster a system; K2/K3 at 256 now run on ns_refine.cu's wgmma
// step, and the file is gone) on one card. Stands alone.
//
//   mkdir -p quadruped_ctrl_tpu_torch/_build
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o quadruped_ctrl_tpu_torch/_build/ns_cluster_probe \
//       quadruped_ctrl_tpu_torch/probes/ns_cluster_probe.cu
//   quadruped_ctrl_tpu_torch/_build/ns_cluster_probe
//
// 1. DSMEM: 4-CTA clusters, one 256-thread CTA per SM (200 KB of shared
//    memory), each CTA reading its 3 peers' 64 KB slabs (what one product
//    moves): into registers; staged as the kernel stages B (4 float4 a
//    thread per 16 KB chunk, split to bf16 hi/lo, stored, __syncthreads);
//    the same from the CTA's own slab; staged with the next chunk's loads
//    issued before the stores; staged with two chunks' loads in flight (the
//    kernel's mm_slab).
// 2. mma.sync rates: m16n8k16 bf16 and m16n8k8 tf32, 8 warps per SM on every
//    SM, 8 independent accumulators a warp.
// 3. Accuracy of one 64 x 256 x 256 product of random operands in [-1, 1]
//    in the kernel's warp layout: fp32 FMAs with k in order (the products
//    before the tensor cores), bf16x3 mmas (the kernel's bf16x3 steps),
//    3xTF32 mmas into one accumulator, and 3xTF32 mmas into a fresh
//    accumulator per 16 k added to the total with an fp32 add (the kernel's
//    fp32 tail). Error: max over entries of
//    |C - C_exact| / (|A| |B|), C_exact in float64 on the host.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <vector>

namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int r) {
  uint32_t o;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(o) : "r"(a), "r"(r));
  return o;
}
__device__ __forceinline__ float4 ld_cluster(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}
__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 1. DSMEM
__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(256)
dsmem(int mode, int rounds, float* out) {
  extern __shared__ __align__(128) float sm[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(sm + 3 * 64 * 256);  // 2 x 16 KB
  cg::cluster_group cl = cg::this_cluster();
  const int q = cl.block_rank();
  for (int i = threadIdx.x; i < 64 * 256; i += 256) sm[i] = i * 1e-3f + q;
  cl.sync();
  const uint32_t base = smem_addr(sm);
  const int tid = threadIdx.x, si = tid / 64, sj = tid % 64;
  float acc = 0.f;
  float4 v[4], w[4];
  auto load = [&](int c, float4 (&x)[4]) {
    const uint32_t rb = map_rank(base, mode == 2 ? q : (q + 1 + c / 4) % 4);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      x[s] = ld_cluster(rb + (((c % 4) * 16 + si + 4 * s) * 256 + 4 * sj) * 4);
  };
  auto store = [&](int c, const float4 (&x)[4]) {
    uint32_t* st = stage + (c & 1) * 4096;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = si + 4 * s;
      uint2 hi, lo;
      split_pair(x[s].x, x[s].y, hi.x, lo.x);
      split_pair(x[s].z, x[s].w, hi.y, lo.y);
      const int off = k * 128 + (((sj >> 1) ^ (k & 7)) << 2) + ((sj & 1) << 1);
      *reinterpret_cast<uint2*>(st + off) = hi;
      *reinterpret_cast<uint2*>(st + 2048 + off) = lo;
    }
    __syncthreads();
    acc += __uint_as_float(stage[(c & 1) * 4096 + tid]);
  };
  for (int it = 0; it < rounds; ++it) {
    if (mode == 0) {
      for (int p = 1; p < 4; ++p) {
        const uint32_t rb = map_rank(base, (q + p) & 3);
#pragma unroll 8
        for (int k = 0; k < 16; ++k) {
          const float4 x = ld_cluster(rb + (k * 1024 + tid * 4) * 4);
          acc += x.x + x.y + x.z + x.w;
        }
      }
    } else if (mode == 3) {  // one chunk ahead
      load(0, v);
      for (int c = 0; c < 12; ++c) {  // 3 slabs of 4 chunks
        store(c, v);
        if (c + 1 < 12) load(c + 1, v);
      }
    } else if (mode == 4) {  // two chunks ahead, as the kernel
      load(0, v);
      load(1, w);
      for (int c = 0; c < 12; c += 2) {
        store(c, v);
        if (c + 2 < 12) load(c + 2, v);
        store(c + 1, w);
        if (c + 3 < 12) load(c + 3, w);
      }
    } else {
      for (int c = 0; c < 12; ++c) {
        load(c, v);
        store(c, v);
      }
    }
  }
  cl.sync();
  if (acc == 12345.f) out[0] = acc;
}

// 2. mma.sync rates (the type a template parameter, so that the loop holds the
// mmas alone)
template <bool kTf32>
__global__ void __launch_bounds__(256) mma_rate(int iters, float* out) {
  float acc[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (kTf32) {
        mma_tf32(acc[n], a, b0, b1);
      } else {
        mma_bf16(acc[n], a, b0, b1);
      }
    }
  }
  float s = 0.f;
  for (int n = 0; n < 8; ++n) s += acc[n][0] + acc[n][1] + acc[n][2] + acc[n][3];
  if (s == 12345.f) out[0] = s;
}

// 3. C (64 x 256) = A (64 x 256) B (256 x 256), row-major in global memory,
// one block of 8 warps in the kernel's layout (warp tile 32 x 64).
__global__ void __launch_bounds__(256) product(const float* A, const float* B, float* C, int mode) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = threadIdx.x >> 7, wn = (threadIdx.x >> 5) & 3;
  float acc[2][8][4] = {};
  auto row = [&](int mt, int h) { return 32 * wm + 16 * mt + g + 8 * h; };
  auto col = [&](int nt) { return 64 * wn + 8 * nt + 2 * t; };
  for (int k0 = 0; k0 < 256; k0 += 16) {
    if (mode == 0) {  // fmaf, k in order
      for (int k = k0; k < k0 + 16; ++k)
        for (int mt = 0; mt < 2; ++mt)
          for (int nt = 0; nt < 8; ++nt)
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] = fmaf(A[row(mt, e >> 1) * 256 + k], B[k * 256 + col(nt) + (e & 1)],
                                    acc[mt][nt][e]);
    } else if (mode == 1) {  // bf16x3
      uint32_t ah[2][4], al[2][4];
      for (int mt = 0; mt < 2; ++mt)
        for (int f = 0; f < 4; ++f) {
          const float* p = A + row(mt, f & 1) * 256 + k0 + 2 * t + 8 * (f >> 1);
          split_pair(p[0], p[1], ah[mt][f], al[mt][f]);
        }
      for (int nt = 0; nt < 8; ++nt) {
        const int n = 64 * wn + 8 * nt + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_pair(B[(k0 + 2 * t) * 256 + n], B[(k0 + 2 * t + 1) * 256 + n], bh0, bl0);
        split_pair(B[(k0 + 2 * t + 8) * 256 + n], B[(k0 + 2 * t + 9) * 256 + n], bh1, bl1);
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][nt], ah[mt], bh0, bh1);
          mma_bf16(acc[mt][nt], ah[mt], bl0, bl1);
          mma_bf16(acc[mt][nt], al[mt], bh0, bh1);
        }
      }
    } else {  // 3xTF32: mode 2 into acc, mode 3 into a fresh chunk accumulator
      float part[2][8][4] = {};
      for (int kk = k0; kk < k0 + 16; kk += 8) {
        uint32_t ah[2][4], al[2][4];
        for (int mt = 0; mt < 2; ++mt)
          for (int f = 0; f < 4; ++f) {
            const float x = A[row(mt, f & 1) * 256 + kk + t + 4 * (f >> 1)];
            ah[mt][f] = to_tf32(x);
            al[mt][f] = to_tf32(x - __uint_as_float(ah[mt][f]));
          }
        for (int nt = 0; nt < 8; ++nt) {
          const int n = 64 * wn + 8 * nt + g;
          const float x0 = B[(kk + t) * 256 + n], x1 = B[(kk + t + 4) * 256 + n];
          const uint32_t bh0 = to_tf32(x0), bh1 = to_tf32(x1);
          const uint32_t bl0 = to_tf32(x0 - __uint_as_float(bh0));
          const uint32_t bl1 = to_tf32(x1 - __uint_as_float(bh1));
          for (int mt = 0; mt < 2; ++mt) {
            float(&d)[4] = mode == 2 ? acc[mt][nt] : part[mt][nt];
            mma_tf32(d, ah[mt], bh0, bh1);
            mma_tf32(d, ah[mt], bl0, bl1);
            mma_tf32(d, al[mt], bh0, bh1);
          }
        }
      }
      if (mode == 3)
        for (int mt = 0; mt < 2; ++mt)
          for (int nt = 0; nt < 8; ++nt)
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    }
  }
  for (int mt = 0; mt < 2; ++mt)
    for (int nt = 0; nt < 8; ++nt)
      for (int e = 0; e < 4; ++e) C[row(mt, e >> 1) * 256 + col(nt) + (e & 1)] = acc[mt][nt][e];
}

int main() {
  cudaDeviceProp pr;
  cudaGetDeviceProperties(&pr, 0);
  printf("%s, %d SMs, %d kHz\n", pr.name, pr.multiProcessorCount, pr.clockRate);
  float* out;
  cudaMalloc(&out, 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  auto time_ms = [&](auto launch) {
    launch(5);
    cudaEventRecord(e0);
    launch(0);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    return ms;
  };

  const int smem = (3 * 64 * 256 + 8192) * 4;
  cudaFuncSetAttribute(dsmem, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const char* names[] = {"peers' slabs into registers", "staged from the peers",
                         "staged from the own slab",
                         "staged from the peers, loads one chunk ahead",
                         "staged from the peers, loads two chunks ahead"};
  const int rounds = 200;
  for (int mode = 0; mode < 5; ++mode) {
    const float ms = time_ms(
        [&](int warm) { dsmem<<<120, 256, smem>>>(mode, warm ? warm : rounds, out); });
    const double bytes = rounds * 3.0 * 65536;  // per CTA
    printf("DSMEM %-45s %.2f us per 196,608 bytes a CTA, %.1f GB/s per SM (120 CTAs) [%s]\n",
           names[mode], ms * 1e3 / rounds, bytes / (ms * 1e-3) / 1e9,
           cudaGetErrorString(cudaGetLastError()));
  }
  for (int tf = 0; tf < 2; ++tf) {
    const int iters = 4096, grid = pr.multiProcessorCount;
    const float ms = time_ms([&](int warm) {
      if (tf) {
        mma_rate<true><<<grid, 256>>>(warm ? 16 : iters, out);
      } else {
        mma_rate<false><<<grid, 256>>>(warm ? 16 : iters, out);
      }
    });
    const double flop = 2.0 * 16 * 8 * (tf ? 8 : 16) * 8.0 * iters * 8 * grid;
    printf("mma.sync %s: %.1f TFLOP/s [%s]\n", tf ? "m16n8k8 tf32  " : "m16n8k16 bf16 ",
           flop / (ms * 1e-3) / 1e12, cudaGetErrorString(cudaGetLastError()));
  }

  std::vector<float> a(64 * 256), b(256 * 256), c(64 * 256);
  uint64_t state = 12345;
  auto uni = [&]() {
    state = state * 6364136223846793005ull + 1442695040888963407ull;
    return static_cast<float>((state >> 40) * (2.0 / 16777216.0) - 1.0);
  };
  for (float& x : a) x = uni();
  for (float& x : b) x = uni();
  float *da, *db, *dc;
  cudaMalloc(&da, a.size() * 4);
  cudaMalloc(&db, b.size() * 4);
  cudaMalloc(&dc, c.size() * 4);
  cudaMemcpy(da, a.data(), a.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(db, b.data(), b.size() * 4, cudaMemcpyHostToDevice);
  const char* pnames[] = {"fp32 FMAs, k in order", "bf16x3 mmas", "3xTF32 mmas, one accumulator",
                          "3xTF32 mmas, an fp32 add per 16 k"};
  for (int mode = 0; mode < 4; ++mode) {
    product<<<1, 256>>>(da, db, dc, mode);
    cudaMemcpy(c.data(), dc, c.size() * 4, cudaMemcpyDeviceToHost);
    double worst = 0.0, sq = 0.0;
    for (int i = 0; i < 64; ++i)
      for (int j = 0; j < 256; ++j) {
        double exact = 0.0, mag = 0.0;
        for (int k = 0; k < 256; ++k) {
          exact += static_cast<double>(a[i * 256 + k]) * b[k * 256 + j];
          mag += std::fabs(static_cast<double>(a[i * 256 + k]) * b[k * 256 + j]);
        }
        const double rel = std::fabs(c[i * 256 + j] - exact) / mag;
        worst = std::fmax(worst, rel);
        sq += rel * rel;
      }
    printf("product %-36s max |C - C_exact| / (|A||B|) %.3e, rms %.3e (2^-24 = 5.96e-08) [%s]\n",
           pnames[mode], worst, std::sqrt(sq / (64 * 256)), cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
