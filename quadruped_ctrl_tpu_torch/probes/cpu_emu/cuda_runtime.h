// CPU stand-in for the part of the CUDA runtime and device language that the
// kernels in csrc/ use, for emulate.py: a launch runs its clusters one after
// another (a launch without a cluster dimension: its blocks), the CTAs of a
// cluster concurrently, each as one std::thread per CUDA thread.
// __syncthreads is a std::barrier over the block, cluster.sync() one over
// every thread of the cluster (cooperative_groups.h), and the warp-wide
// operations (shuffles, and mma.sync / ldmatrix in emu_mma.h) exchange values
// through a per-warp scratch area between two barriers over the warp's 32
// threads (wgmma: over the warpgroup's 128); __syncwarp is one barrier over
// the warp. Dynamic shared memory is
// one arena per block, filled with garbage; a peer's arena is what
// map_shared_rank and mapa / ld.shared::cluster (emu_mma.h) reach. Static
// __shared__ variables live in the same arena, above the most dynamic shared
// memory a block may have: emulate.py rewrites each declaration into a call
// of emu::cta_static, which gives every variable one offset, the same in
// every block, so map_shared_rank reaches a peer's copy too.
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
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
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
struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline thread_local uint3 threadIdx;
inline thread_local uint3 blockIdx;
inline thread_local uint3 gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaErrorInvalidConfiguration = 9;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributeNonPortableClusterSizeAllowed
};
// Refuses what the card refuses: more than 232,448 bytes of shared memory a block.
template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute attr, int value) {
  return attr != cudaFuncAttributeMaxDynamicSharedMemorySize || value <= 232448
             ? cudaSuccess
             : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// The cluster launch API: cudaLaunchKernelEx with a cluster dimension (below,
// after emu::launch).
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
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  int numAttrs;
};
// The emulated card is small, so that a persistent kernel's blocks walk more
// than one system: 2 SMs, one block an SM, 2 clusters at once.
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, cudaLaunchConfig_t*) {
  *n = 2;
  return cudaSuccess;
}
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  uint32_t u[32][8];
  float f[32][8];
};
struct WarpGroup {
  std::barrier<> bar{128};
  uint32_t a[128][4];
};

// The calling thread's block: its arena, barrier and warps; its cluster: its
// block's rank, every block's arena, one barrier over all their threads.
inline thread_local char* arena = nullptr;
inline thread_local size_t arena_bytes = 0;
inline thread_local std::barrier<>* block_bar = nullptr;
inline thread_local Warp* warps = nullptr;
inline thread_local WarpGroup* warpgroups = nullptr;
inline thread_local unsigned cluster_rank = 0;
inline thread_local unsigned cluster_size = 1;
inline thread_local char* const* cluster_arenas = nullptr;
inline thread_local std::barrier<>* cluster_bar = nullptr;

// Static __shared__ variables: kStaticBytes at kStaticBase of each arena.
constexpr size_t kStaticBase = 232448, kStaticBytes = 16384;
inline size_t static_alloc(size_t bytes, size_t align) {
  static std::mutex mu;
  static size_t top = 0;
  std::lock_guard<std::mutex> lock(mu);
  top = (top + align - 1) / align * align;
  const size_t at = top;
  top += bytes;
  if (top > kStaticBytes) {
    std::fprintf(stderr, "static __shared__ variables over %zu bytes\n", kStaticBytes);
    std::abort();
  }
  return at;
}
// The calling block's copy of static __shared__ variable kId (of type T).
template <typename T, int kId>
inline T& cta_static() {
  static const size_t at = static_alloc(sizeof(T), alignof(T));
  return *reinterpret_cast<T*>(arena + kStaticBase + at);
}

inline void launch(int grid, int block, size_t smem, cudaStream_t,
                   const std::function<void()>& kernel, int cluster = 1) {
  for (int c0 = 0; c0 < grid; c0 += cluster) {
    std::vector<std::vector<char>> bufs;
    std::vector<char*> arenas;
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<std::unique_ptr<Warp[]>> ws;
    std::vector<std::unique_ptr<WarpGroup[]>> wgs;
    for (int r = 0; r < cluster; ++r) {
      bufs.emplace_back(kStaticBase + kStaticBytes + 256, 0x7f);
      arenas.push_back(reinterpret_cast<char*>(
          (reinterpret_cast<uintptr_t>(bufs.back().data()) + 127) & ~uintptr_t(127)));
      bars.push_back(std::make_unique<std::barrier<>>(block));
      ws.push_back(std::make_unique<Warp[]>(block / 32));
      wgs.push_back(std::make_unique<WarpGroup[]>((block + 127) / 128));
    }
    std::barrier<> cbar(cluster * block);
    std::vector<std::thread> threads;
    for (int r = 0; r < cluster; ++r)
      for (int t = 0; t < block; ++t)
        threads.emplace_back([&, r, t] {
          threadIdx.x = t;
          blockIdx.x = c0 + r;
          gridDim.x = grid;
          arena = arenas[r];
          arena_bytes = smem;
          block_bar = bars[r].get();
          warps = ws[r].get();
          warpgroups = wgs[r].get();
          cluster_rank = r;
          cluster_size = cluster;
          cluster_arenas = arenas.data();
          cluster_bar = &cbar;
          kernel();
        });
    for (auto& th : threads) th.join();
  }
}
inline Warp& warp() { return warps[threadIdx.x >> 5]; }
inline WarpGroup& warpgroup() { return warpgroups[threadIdx.x >> 7]; }
inline int lane() { return threadIdx.x & 31; }
}  // namespace emu

// Refuses what the card refuses: clusters above 16 CTAs, a grid that is no
// whole number of clusters.
template <typename... Exp, typename... Act>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Exp...),
                                      Act&&... args) {
  int cluster = 1;
  for (int i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = static_cast<int>(cfg->attrs[i].val.clusterDim.x);
  if (cluster < 1 || cluster > 16 || cfg->gridDim.x % cluster != 0) return cudaErrorInvalidValue;
  emu::launch(static_cast<int>(cfg->gridDim.x), static_cast<int>(cfg->blockDim.x),
              cfg->dynamicSmemBytes, cfg->stream, [&] { kernel(args...); }, cluster);
  return cudaSuccess;
}

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

inline float __shfl_sync(unsigned, float v, int src) {
  auto& w = emu::warp();
  const int l = emu::lane();
  w.f[l][7] = v;
  w.bar.arrive_and_wait();
  const float r = w.f[src & 31][7];
  w.bar.arrive_and_wait();
  return r;
}

inline int __shfl_up_sync(unsigned, int v, int delta) {
  auto& w = emu::warp();
  const int l = emu::lane();
  w.u[l][7] = static_cast<uint32_t>(v);
  w.bar.arrive_and_wait();
  const int r = l >= delta ? static_cast<int>(w.u[l - delta][7]) : v;
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
