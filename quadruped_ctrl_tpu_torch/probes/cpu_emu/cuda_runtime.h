// CPU stand-in for the part of the CUDA runtime and device language that the
// kernels in csrc/ use, for emulate.py: a launch runs its blocks one after
// another, each block as one std::thread per CUDA thread; __syncthreads is a
// std::barrier over the block, and the warp-wide operations (shuffles, and
// mma.sync / ldmatrix in emu_mma.h) exchange values through a per-warp
// scratch area between two barriers over the warp's 32 threads; __syncwarp is
// one barrier over the warp. Static
// __shared__ variables become function statics (one block runs at a time);
// dynamic shared memory is one arena per block, filled with garbage.
#pragma once

#include <math.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __cluster_dims__(...)

struct uint3 {
  unsigned x = 0, y = 0, z = 0;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) uint2 {
  uint32_t x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline thread_local uint3 threadIdx;
inline thread_local uint3 blockIdx;

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
// Refuses what the card refuses: more than 232,448 bytes of shared memory a block.
template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// Enough of the cluster launch API for ns_cluster.cu to compile (its 4-CTA
// clusters are not emulated).
struct cudaLaunchAttributeValue {
  dim3 clusterDim;
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaLaunchAttribute* attrs;
  int numAttrs;
};
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, cudaLaunchConfig_t*) {
  *n = 0;
  return cudaSuccess;
}

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  uint32_t u[32][8];
  float f[32][8];
};
inline char* arena = nullptr;
inline std::barrier<>* block_bar = nullptr;
inline Warp* warps = nullptr;

inline void launch(int grid, int block, size_t smem, cudaStream_t,
                   const std::function<void()>& kernel) {
  for (int bx = 0; bx < grid; ++bx) {
    std::vector<char> buf(smem + 256, 0x7f);
    arena = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(buf.data()) + 127) &
                                    ~uintptr_t(127));
    std::barrier<> bar(block);
    block_bar = &bar;
    std::vector<Warp> ws(block / 32);
    warps = ws.data();
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t, bx] {
        threadIdx.x = t;
        blockIdx.x = bx;
        kernel();
      });
    for (auto& th : threads) th.join();
  }
}
inline Warp& warp() { return warps[threadIdx.x >> 5]; }
inline int lane() { return threadIdx.x & 31; }
}  // namespace emu

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }

inline int __syncthreads_and(int p) {
  static std::atomic<int> all{1};
  if (!p) all = 0;
  __syncthreads();
  const int r = all;
  __syncthreads();
  if (threadIdx.x == 0) all = 1;
  __syncthreads();
  return r;
}

inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp().bar.arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int off) {
  auto& w = emu::warp();
  const int l = emu::lane();
  w.f[l][7] = v;
  w.bar.arrive_and_wait();
  const float r = w.f[l ^ off][7];
  w.bar.arrive_and_wait();
  return r;
}

inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<size_t>(reinterpret_cast<const char*>(p) - emu::arena);
}
inline float __ldg(const float* p) { return *p; }
inline float4 __ldg(const float4* p) { return *p; }
using std::max;
using std::min;
