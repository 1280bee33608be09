// CPU stand-in for the part of the CUDA runtime and device language that the
// kernels in csrc/ use, for emulate.py: a launch runs its clusters one after
// another (a launch without a cluster dimension: its blocks), the CTAs of a
// cluster together, each CUDA thread as a fiber on the thread that called
// the entry point; no launch starts a thread of its own.
//
// The order is fixed: a cluster's fibers start in the order (CTA rank,
// thread index), and the runnable ones resume first in, first out. A fiber
// runs until it waits at a barrier or returns. Every arrival at a barrier but
// the last switches to the scheduler; the last makes the waiters runnable,
// in the order they arrived, and runs on. So of two threads that exchange
// data with no barrier between them, the one resumed first reads the
// other's slot before it is written (the arena's 0x7f fill), on every run.
// A switch is a _setjmp / _longjmp pair, no system call: a fiber enters its
// stack once, through makecontext, then runs thread after thread, launch
// after launch. Its stack is kStack (256 KiB), above a guard page.
//
// A deadlock, no fiber runnable while some have not returned (a barrier that
// not all of its threads reach), abandons the launch: it prints each barrier
// whose count fell short and records cudaErrorLaunchTimeout, which the next
// cudaGetLastError() returns and clears, as CUDA does an error that is not
// sticky.
//
// __syncthreads is a barrier over the block, cluster.sync() one over
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
#include <setjmp.h>
#include <sys/mman.h>
#include <ucontext.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __cluster_dims__(...)
#define __grid_constant__

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
constexpr int cudaErrorLaunchTimeout = 702;
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
struct Fiber;

// A barrier over `count` threads, with std::barrier's arrive_and_wait; its
// name is for the deadlock report.
struct Barrier {
  explicit Barrier(int n) : count(n) {}
  void arrive_and_wait();
  int count, arrived = 0;
  std::vector<Fiber*> waiters;
  char name[96] = "";
};
struct Warp {
  Barrier bar{32};
  uint32_t u[32][8];
  float f[32][8];
};
struct WarpGroup {
  Barrier bar{128};
  uint32_t a[128][4];
};

// A CUDA thread as the kernel and the stand-ins see it: its indices; its
// block's arena, barrier and warps; its cluster: its block's rank, every
// block's arena, one barrier over all their threads.
struct Thread {
  uint3 thread_idx, block_idx, grid_dim;
  char* arena;
  size_t arena_bytes;
  Barrier* block_bar;
  Warp* warps;
  WarpGroup* warpgroups;
  unsigned cluster_rank, cluster_size;
  char* const* cluster_arenas;
  Barrier* cluster_bar;
};
// The running fiber's thread, installed by the scheduler at each resume
// (its indices copied into threadIdx, blockIdx and gridDim).
inline thread_local Thread* self = nullptr;
inline thread_local cudaError_t last_error = cudaSuccess;
}  // namespace emu

inline cudaError_t cudaGetLastError() {
  const cudaError_t err = emu::last_error;
  emu::last_error = cudaSuccess;
  return err;
}

namespace emu {
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
  return *reinterpret_cast<T*>(self->arena + kStaticBase + at);
}

constexpr size_t kStack = 256 << 10, kGuard = 4096;

struct Fiber {
  Thread t;
  jmp_buf ctx;  // where it resumes
  char* stack = nullptr;
  bool done = true;
  const Barrier* waiting = nullptr;
  ~Fiber() { munmap(stack, kGuard + kStack); }
};

// The calling OS thread's fibers and the launch it runs.
struct Scheduler {
  jmp_buf home;
  Fiber* running = nullptr;
  const std::function<void()>* kernel = nullptr;
  std::deque<Fiber*> ready;
  std::vector<std::unique_ptr<Fiber>> pool;
};
inline Scheduler& scheduler() {
  static thread_local Scheduler s;
  return s;
}

// From the running fiber to the scheduler; returns when it is resumed.
inline void park() {
  Scheduler& s = scheduler();
  if (!_setjmp(s.running->ctx)) _longjmp(s.home, 1);
}

// Runs f until it parks.
inline void resume(Scheduler& s, Fiber* f) {
  s.running = f;
  self = &f->t;
  threadIdx = f->t.thread_idx;
  blockIdx = f->t.block_idx;
  gridDim = f->t.grid_dim;
  if (!_setjmp(s.home)) _longjmp(f->ctx, 1);
}

// A fiber's life: parked until the scheduler gives it a thread to run.
[[noreturn]] inline void fiber_main() {
  Scheduler& s = scheduler();
  for (;;) {
    park();
    (*s.kernel)();
    s.running->done = true;
  }
}

inline std::unique_ptr<Fiber> new_fiber(Scheduler& s) {
  auto f = std::make_unique<Fiber>();
  void* m = mmap(nullptr, kGuard + kStack, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
  if (m == MAP_FAILED || mprotect(m, kGuard, PROT_NONE) != 0) {
    std::perror("emu: a fiber stack");
    std::abort();
  }
  f->stack = static_cast<char*>(m);
  ucontext_t uc;
  getcontext(&uc);
  uc.uc_stack.ss_sp = f->stack + kGuard;
  uc.uc_stack.ss_size = kStack;
  uc.uc_link = nullptr;
  makecontext(&uc, fiber_main, 0);
  s.running = f.get();
  if (!_setjmp(s.home)) setcontext(&uc);  // it parks at once
  return f;
}

inline void Barrier::arrive_and_wait() {
  Scheduler& s = scheduler();
  if (++arrived < count) {
    s.running->waiting = this;
    waiters.push_back(s.running);
    park();
    return;
  }
  arrived = 0;
  for (Fiber* f : waiters) {
    f->waiting = nullptr;
    s.ready.push_back(f);
  }
  waiters.clear();
}

inline void launch(int grid, int block, size_t smem, cudaStream_t,
                   const std::function<void()>& kernel, int cluster = 1) {
  Scheduler& s = scheduler();
  const size_t n = static_cast<size_t>(cluster) * block;
  while (s.pool.size() < n) s.pool.push_back(new_fiber(s));
  s.kernel = &kernel;
  for (int c0 = 0; c0 < grid; c0 += cluster) {
    std::vector<std::vector<char>> bufs;
    std::vector<char*> arenas;
    std::vector<std::unique_ptr<Barrier>> bars;
    std::vector<std::unique_ptr<Warp[]>> ws;
    std::vector<std::unique_ptr<WarpGroup[]>> wgs;
    for (int r = 0; r < cluster; ++r) {
      bufs.emplace_back(kStaticBase + kStaticBytes + 256, 0x7f);
      arenas.push_back(reinterpret_cast<char*>(
          (reinterpret_cast<uintptr_t>(bufs.back().data()) + 127) & ~uintptr_t(127)));
      bars.push_back(std::make_unique<Barrier>(block));
      std::snprintf(bars.back()->name, sizeof bars.back()->name, "__syncthreads of block %d",
                    c0 + r);
      ws.push_back(std::make_unique<Warp[]>(block / 32));
      for (int w = 0; w < block / 32; ++w)
        std::snprintf(ws.back()[w].bar.name, sizeof ws.back()[w].bar.name,
                      "warp %d of block %d (__syncwarp, shuffles, mma.sync, ldmatrix)", w, c0 + r);
      wgs.push_back(std::make_unique<WarpGroup[]>((block + 127) / 128));
      for (int w = 0; w < (block + 127) / 128; ++w)
        std::snprintf(wgs.back()[w].bar.name, sizeof wgs.back()[w].bar.name,
                      "warpgroup %d of block %d (named barrier, wgmma)", w, c0 + r);
    }
    Barrier cbar(cluster * block);
    std::snprintf(cbar.name, sizeof cbar.name, "cluster.sync() of blocks %d-%d", c0,
                  c0 + cluster - 1);
    for (int r = 0; r < cluster; ++r)
      for (int t = 0; t < block; ++t) {
        Fiber* f = s.pool[static_cast<size_t>(r) * block + t].get();
        f->t = Thread{uint3{static_cast<unsigned>(t)}, uint3{static_cast<unsigned>(c0 + r)},
                      uint3{static_cast<unsigned>(grid)}, arenas[r], smem, bars[r].get(),
                      ws[r].get(), wgs[r].get(), static_cast<unsigned>(r),
                      static_cast<unsigned>(cluster), arenas.data(), &cbar};
        f->done = false;
        s.ready.push_back(f);
      }
    while (!s.ready.empty()) {
      Fiber* f = s.ready.front();
      s.ready.pop_front();
      resume(s, f);
    }
    self = nullptr;
    std::vector<const Barrier*> short_of;
    for (size_t i = 0; i < n; ++i)
      if (const Barrier* b = s.pool[i]->waiting;
          !s.pool[i]->done && std::find(short_of.begin(), short_of.end(), b) == short_of.end())
        short_of.push_back(b);
    if (!short_of.empty()) {
      std::fprintf(stderr, "emu::launch: deadlock in the cluster of blocks %d-%d; short:\n", c0,
                   c0 + cluster - 1);
      for (const Barrier* b : short_of)
        std::fprintf(stderr, "  %s: %d of %d threads arrived\n", b->name, b->arrived, b->count);
      std::erase_if(s.pool, [](const std::unique_ptr<Fiber>& f) { return !f->done; });
      last_error = cudaErrorLaunchTimeout;
      return;
    }
  }
}
inline Warp& warp() { return self->warps[threadIdx.x >> 5]; }
inline WarpGroup& warpgroup() { return self->warpgroups[threadIdx.x >> 7]; }
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

inline void __syncthreads() { emu::self->block_bar->arrive_and_wait(); }

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
  return static_cast<size_t>(reinterpret_cast<const char*>(p) - emu::self->arena);
}
// The rounded arithmetic intrinsics: one IEEE operation each, never contracted.
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __ldg(const float* p) { return *p; }
inline float4 __ldg(const float4* p) { return *p; }
using std::max;
using std::min;
