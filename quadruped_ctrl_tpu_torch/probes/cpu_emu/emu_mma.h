// CPU stand-ins for the inline PTX of csrc/mma.cuh (cvt.rna.tf32.f32,
// mma.sync m16n8k16 bf16 and m16n8k8 tf32, ldmatrix.x4.trans, mapa and
// ld.shared::cluster, wgmma m64nNk8 tf32 and m64n128k16 bf16 and their
// fences, cp.async), on the PTX ISA's
// fragment layouts: each lane posts its registers to its warp's (wgmma: its
// warpgroup's) scratch area, and after a barrier every lane reads what the
// instruction would give it. wgmma runs when it is issued, B read through
// its descriptor (start, leading and stride byte offsets; no swizzle), so
// its commit and wait, and the proxy fence before it, do nothing here, and
// cp.async copies at once. A
// shared::cluster address is the CTA rank + 1 above bit 20 and the offset in
// that CTA's arena below it; ld.shared::cluster aborts outside the arena or
// off a 16-byte boundary. ldmatrix also counts the shared-memory wavefronts
// of each 8x8 matrix (1 when free of bank conflicts) and aborts on a
// misaligned row; mma.sync m16n8k16 bf16 counts the warp-wide mmas it runs.
#pragma once

#include "cuda_runtime.h"

namespace qct {
__device__ __forceinline__ uint32_t to_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & ~0x1FFFu;
}
inline float lo16(uint32_t u) { return __uint_as_float(u << 16); }
inline float hi16(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

inline std::atomic<long> mma_bf16_calls{0};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  auto& w = emu::warp();
  const int l = emu::lane();
  if (l == 0) ++mma_bf16_calls;
  for (int i = 0; i < 4; ++i) w.u[l][i] = a[i];
  w.u[l][4] = b0; w.u[l][5] = b1;
  w.bar.arrive_and_wait();
  float A[16][16], B[16][8];
  for (int L = 0; L < 32; ++L) {
    const int g = L >> 2, t = L & 3;
    const uint32_t* u = w.u[L];
    A[g][2 * t] = lo16(u[0]); A[g][2 * t + 1] = hi16(u[0]);
    A[g + 8][2 * t] = lo16(u[1]); A[g + 8][2 * t + 1] = hi16(u[1]);
    A[g][2 * t + 8] = lo16(u[2]); A[g][2 * t + 9] = hi16(u[2]);
    A[g + 8][2 * t + 8] = lo16(u[3]); A[g + 8][2 * t + 9] = hi16(u[3]);
    B[2 * t][g] = lo16(u[4]); B[2 * t + 1][g] = hi16(u[4]);
    B[2 * t + 8][g] = lo16(u[5]); B[2 * t + 9][g] = hi16(u[5]);
  }
  w.bar.arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), c = 2 * t + (e & 1);
    float s = 0.f;
    for (int k = 0; k < 16; ++k) s += A[r][k] * B[k][c];
    d[e] += s;
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  auto& w = emu::warp();
  const int l = emu::lane();
  for (int i = 0; i < 4; ++i) w.u[l][i] = a[i];
  w.u[l][4] = b0; w.u[l][5] = b1;
  w.bar.arrive_and_wait();
  float A[16][8], B[8][8];
  for (int L = 0; L < 32; ++L) {
    const int g = L >> 2, t = L & 3;
    const uint32_t* u = w.u[L];
    A[g][t] = __uint_as_float(u[0]); A[g + 8][t] = __uint_as_float(u[1]);
    A[g][t + 4] = __uint_as_float(u[2]); A[g + 8][t + 4] = __uint_as_float(u[3]);
    B[t][g] = __uint_as_float(u[4]); B[t + 4][g] = __uint_as_float(u[5]);
  }
  w.bar.arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), c = 2 * t + (e & 1);
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += A[r][k] * B[k][c];
    d[e] += s;
  }
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  if (addr >= (1u << 20) || rank < 0 || static_cast<unsigned>(rank) >= emu::cluster_size) {
    std::fprintf(stderr, "mapa: address %u or rank %d out of range\n", addr, rank);
    std::abort();
  }
  return (static_cast<uint32_t>(rank + 1) << 20) | addr;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  const uint32_t rank = (addr >> 20) - 1, off = addr & 0xFFFFFu;
  if (addr < (1u << 20) || rank >= emu::cluster_size || off % 16 ||
      off + 16 > emu::arena_bytes) {
    std::fprintf(stderr, "ld.shared::cluster: bad address %u (rank %u, offset %u)\n", addr,
                 rank, off);
    std::abort();
  }
  float4 v;
  std::memcpy(&v, emu::cluster_arenas[rank] + off, 16);
  return v;
}

__device__ __forceinline__ void wg_fence() {}
__device__ __forceinline__ void wg_commit() {}
__device__ __forceinline__ void wg_wait_all() {}
__device__ __forceinline__ void fence_proxy_async() {}
__device__ __forceinline__ void wg_bar(int) { emu::warpgroup().bar.arrive_and_wait(); }
__device__ __forceinline__ void wg_hold_f(float&) {}
__device__ __forceinline__ void wg_hold_r(uint32_t&) {}

// d (+)= a b for the warpgroup's m64nNk8 tile: a0..a3 of warp w hold rows
// 16 w + g (+ 8) of columns t (+ 4); d[4 j + e] is row 16 w + g + 8 (e / 2),
// column 8 j + 2 t + e % 2; B (k, n) at start + (n / 8) sbo + (k / 4) lbo +
// (n % 8) 16 + (k % 4) 4 bytes of its descriptor. Operands are read as tf32
// (low 13 bits dropped); each entry is an 8-term fp32 sum added to d
// (scale_d) or not.
template <int N>
inline void emu_wgmma(float* d, const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  auto& w = emu::warpgroup();
  const int l = threadIdx.x & 127;
  for (int i = 0; i < 4; ++i) w.a[l][i] = a[i];
  w.bar.arrive_and_wait();
  const uint32_t start = static_cast<uint32_t>(desc & 0x3FFF) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3FFF) << 4;
  if (start + (N / 8 - 1) * sbo + lbo + 128 > emu::arena_bytes) {
    std::fprintf(stderr, "wgmma: B operand outside shared memory (start %u)\n", start);
    std::abort();
  }
  const int wq = l >> 5, g = (l & 31) >> 2, t = l & 3;
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * wq + g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
      float s = 0.f;
      for (int k = 0; k < 8; ++k) {
        const int src = 32 * wq + 4 * (r % 8) + k % 4, reg = (r % 16 >= 8) + 2 * (k >= 4);
        uint32_t b;
        std::memcpy(&b, emu::arena + start + (n / 8) * sbo + (k / 4) * lbo + (n % 8) * 16 +
                            (k % 4) * 4, 4);
        s += __uint_as_float(w.a[src][reg] & ~0x1FFFu) * __uint_as_float(b & ~0x1FFFu);
      }
      d[4 * j + e] = scale_d ? d[4 * j + e] + s : s;
    }
  w.bar.arrive_and_wait();
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  emu_wgmma<128>(d, a, desc, scale_d);
}
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  emu_wgmma<32>(d, a, desc, scale_d);
}
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  emu_wgmma<16>(d, a, desc, scale_d);
}

// d (+)= a b for the warpgroup's m64nNk16 tile in bf16: a0..a3 of warp w
// hold rows 16 w + g (+ 8) of k 2t, 2t + 1 (+ 8), the lower k in the low
// half; B (k, n) at start + (n / 8) sbo + (k / 8) lbo + (n % 8) 16 + (k % 8) 2
// bytes of its descriptor (K-major, no swizzle); d as emu_wgmma's. Each
// entry is a 16-term fp32 sum of exact bf16 products, added to d (scale_d)
// or not.
template <int N>
inline void emu_wgmma_bf16(float* d, const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  auto& w = emu::warpgroup();
  const int l = threadIdx.x & 127;
  for (int i = 0; i < 4; ++i) w.a[l][i] = a[i];
  w.bar.arrive_and_wait();
  const uint32_t start = static_cast<uint32_t>(desc & 0x3FFF) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3FFF) << 4;
  if (start + (N / 8 - 1) * sbo + lbo + 128 > emu::arena_bytes) {
    std::fprintf(stderr, "wgmma: B operand outside shared memory (start %u)\n", start);
    std::abort();
  }
  const int wq = l >> 5, g = (l & 31) >> 2, t = l & 3;
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * wq + g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
      float s = 0.f;
      for (int k = 0; k < 16; ++k) {
        const uint32_t u = w.a[32 * wq + 4 * (r % 8) + (k % 8) / 2][(r % 16 >= 8) + 2 * (k >= 8)];
        uint16_t b;
        std::memcpy(&b, emu::arena + start + (n / 8) * sbo + (k / 8) * lbo + (n % 8) * 16 +
                            (k % 8) * 2, 2);
        s += (k & 1 ? hi16(u) : lo16(u)) * __uint_as_float(static_cast<uint32_t>(b) << 16);
      }
      d[4 * j + e] = scale_d ? d[4 * j + e] + s : s;
    }
  w.bar.arrive_and_wait();
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  emu_wgmma_bf16<128>(d, a, desc, scale_d);
}

// cp.async runs when it is issued, so its wait does nothing here; a
// misaligned 16-byte copy aborts.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  if (reinterpret_cast<uintptr_t>(dst) % 16 || reinterpret_cast<uintptr_t>(src) % 16) {
    std::fprintf(stderr, "cp.async: a 16-byte copy off a 16-byte boundary\n");
    std::abort();
  }
  std::memcpy(dst, src, 16);
}
__device__ __forceinline__ void cp_async_wait_all() {}

inline std::atomic<long> ldsm_wavefronts{0}, ldsm_matrices{0};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  auto& w = emu::warp();
  const int l = emu::lane();
  w.u[l][6] = addr;
  w.bar.arrive_and_wait();
  if (l == 0) {  // bank conflicts: each 8-lane phase reads 8 rows of 16 bytes
    for (int m = 0; m < 4; ++m) {
      int banks[32] = {0};
      int worst = 0;
      for (int j = 0; j < 8; ++j) {
        const uint32_t a = w.u[8 * m + j][6];
        if (a % 16) {
          std::fprintf(stderr, "ldmatrix: misaligned row address %u\n", a);
          std::abort();
        }
        for (int q = 0; q < 4; ++q) worst = std::max(worst, ++banks[(a / 4 + q) % 32]);
      }
      ldsm_wavefronts += worst;
    }
    ldsm_matrices += 4;
  }
  for (int m = 0; m < 4; ++m) {
    const uint32_t a0 = w.u[8 * m + 2 * (l & 3)][6], a1 = w.u[8 * m + 2 * (l & 3) + 1][6];
    uint16_t v0, v1;
    std::memcpy(&v0, emu::arena + a0 + 2 * (l >> 2), 2);
    std::memcpy(&v1, emu::arena + a1 + 2 * (l >> 2), 2);
    r[m] = static_cast<uint32_t>(v0) | (static_cast<uint32_t>(v1) << 16);
  }
  w.bar.arrive_and_wait();
}
}  // namespace qct

extern "C" long emu_mma_bf16_count() { return qct::mma_bf16_calls; }

extern "C" void emu_reset_counts() {
  qct::mma_bf16_calls = 0;
  qct::ldsm_wavefronts = 0;
  qct::ldsm_matrices = 0;
}

extern "C" double emu_ldsm_wavefronts_per_matrix() {
  return qct::ldsm_matrices ? double(qct::ldsm_wavefronts) / double(qct::ldsm_matrices) : 0.0;
}
