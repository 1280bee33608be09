// CPU stand-ins for the inline PTX of csrc/mma.cuh (cvt.rna.tf32.f32,
// mma.sync m16n8k16 bf16 and m16n8k8 tf32, ldmatrix.x4.trans), on the PTX
// ISA's fragment layouts: each lane posts its registers to its warp's scratch
// area, and after a warp barrier every lane reads what the instruction would
// give it. ldmatrix also counts the shared-memory wavefronts of each 8x8
// matrix (1 when free of bank conflicts) and aborts on a misaligned row;
// mma.sync m16n8k16 bf16 counts the warp-wide mmas it runs.
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
