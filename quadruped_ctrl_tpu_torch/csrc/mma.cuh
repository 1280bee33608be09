// The Newton-Schulz product on the tensor cores, the parts both tiles share
// (ns_core.cuh at 128, one block a system; ns_cluster.cu at 256, a 4-CTA
// cluster a system): the bf16 and tf32 hi/lo splits, mma.sync m16n8k16 bf16
// and m16n8k8 tf32, ldmatrix.trans, the swizzled fp32 tiles and bf16 staging
// planes, and one 16-row chunk of k of a product for a warp's 32 x 64 output
// tile, with its epilogues. A kN-column output is computed by 8 warps
// (256 threads), kN / 64 warp tiles across.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace qct {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> bf16x2 hi and lo, x in the low half: hi = bf16(x), lo = bf16(x - hi),
// both rounded to nearest.
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

// a -> tf32 hi and lo, hi = tf32(a), lo = tf32(a - hi).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The calling thread's place in the mma layouts of a kN-column output that 8
// warps compute in 32 x 64 tiles, kN / 64 of them across: fragment row g and
// column pair t, and its warp's tile (rows 32 wm, columns 64 wn).
template <int kN>
struct Lane {
  static constexpr unsigned kWarpCols = kN / 64;
  int g, t, wm, wn;
  __device__ __forceinline__ Lane()
      : g((threadIdx.x & 31) >> 2), t(threadIdx.x & 3), wm((threadIdx.x >> 5) / kWarpCols),
        wn((threadIdx.x >> 5) % kWarpCols) {}
  // row of accumulator entries acc[mt][*][2h, 2h+1]; column of acc[*][nt][0]
  __device__ __forceinline__ int row(int mt, int h) const { return 32 * wm + 16 * mt + g + 8 * h; }
  __device__ __forceinline__ int col(int nt) const { return 64 * wn + 8 * nt + 2 * t; }
};

// A warp's 32 x 64 output tile: 2 x 8 mma fragments of 16 x 8.
using Acc = float[2][8][4];

constexpr int KC = 16;    // rows of B (k) per chunk of a product
constexpr int WARPS = 8;  // warps of a block

// Element (r, c) of a tile of kN columns in shared memory: the columns of row
// r are XOR-swizzled by 8 (r % 4), which keeps float2 and float4 groups whole
// and makes the fragment loads and the epilogue's float2 stores free of bank
// conflicts without padding.
template <int kN>
__device__ __forceinline__ int sw(int r, int c) {
  return r * kN + (c ^ ((r & 3) << 3));
}

// One float4 of B's chunk (row k < KC, columns 4 sj..4 sj + 3) split into
// the staging buffer st: hi and lo planes of KC x kN bf16 (KC * kN / 2 words
// each), row k's 16-byte groups XOR-swizzled by k % 8 for ldmatrix.trans.
template <int kN>
__device__ __forceinline__ void stage_split(uint32_t* st, const float4& v, int k, int sj) {
  uint2 hi, lo;
  split_pair(v.x, v.y, hi.x, lo.x);
  split_pair(v.z, v.w, hi.y, lo.y);
  const int off = k * (kN / 2) + (((sj >> 1) ^ (k & 7)) << 2) + ((sj & 1) << 1);
  *reinterpret_cast<uint2*>(st + off) = hi;
  *reinterpret_cast<uint2*>(st + KC * kN / 2 + off) = lo;
}

// acc += A[:, kg:kg+16] @ (the chunk staged in st) for the warp's tile,
// bf16x3: A's fragments read from its swizzled fp32 tile and split as they
// load, B's from the planes, three mma passes (hi*hi, hi*lo, lo*hi) into one
// fp32 accumulator.
template <int kN>
__device__ __forceinline__ void mma_chunk_bf16(const float* __restrict__ A, const uint32_t* st,
                                               int kg, const Lane<kN>& ln, Acc& acc) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {  // a0..a3: rows g, g+8 of columns 2t and 2t+8
      const int r = ln.row(mt, f & 1), c = kg + 2 * ln.t + 8 * (f >> 1);
      const float2 x = *reinterpret_cast<const float2*>(A + sw<kN>(r, c));
      split_pair(x.x, x.y, ah[mt][f], al[mt][f]);
    }
  }
  // ldmatrix.x4.trans: lanes 8m..8m+7 address rows k = lane % 8 + 8 (m % 2) of
  // columns 8 (m / 2) on: b0, b1 of two neighbouring 8-column tiles
  const int lane = threadIdx.x & 31;
  const int k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t plane = smem_addr(st) + k * kN * 2;   // bytes: kN bf16 a row
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    const int grp = (64 * ln.wn + 16 * np) / 8 + (lane >> 4);
    const uint32_t off = ((grp ^ (k & 7)) << 4);
    uint32_t bh[4], bl[4];
    ldsm_x4_trans(plane + off, bh);
    ldsm_x4_trans(plane + KC * kN * 2 + off, bl);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float(&d)[4] = acc[mt][2 * np + h];
        mma_bf16(d, ah[mt], bh[2 * h], bh[2 * h + 1]);
        mma_bf16(d, ah[mt], bl[2 * h], bl[2 * h + 1]);
        mma_bf16(d, al[mt], bh[2 * h], bh[2 * h + 1]);
      }
    }
  }
}

// acc += A[:, kg:kg+16] @ B[brow:brow+16, :] for the warp's tile, 3xTF32;
// B is a swizzled fp32 tile of kN columns (brow a multiple of 16). Per 8 k
// the passes hi*hi, hi*lo, lo*hi of tf32 parts (m16n8k8 mmas) into a fresh
// accumulator, which one fp32 add per entry takes into acc: one accumulator
// over all the terms loses ~4x fmaf's accuracy, 16 terms per add do not
// (PERF.md; probes/ns_cluster_probe.cu). One 16-row fragment row at a time,
// which keeps the fresh accumulator at 32 registers.
template <int kN>
__device__ __forceinline__ void mma_chunk_tf32(const float* __restrict__ A, const float* B,
                                               int brow, int kg, const Lane<kN>& ln, Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float part[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {  // a0..a3: rows g, g+8 of columns t and t+4
        const float x = A[sw<kN>(ln.row(mt, f & 1), kg + kk + ln.t + 4 * (f >> 1))];
        split_tf32(x, ah[f], al[f]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        // b0, b1: rows brow + kk + t and + t + 4 of column n, both swizzled
        // by 8 t (row % 4 == t: no bank conflicts)
        const int sn = (64 * ln.wn + 8 * nt + ln.g) ^ (ln.t << 3);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(B[(brow + kk + ln.t) * kN + sn], bh0, bl0);
        split_tf32(B[(brow + kk + ln.t + 4) * kN + sn], bh1, bl1);
        mma_tf32(part[nt], ah, bh0, bh1);
        mma_tf32(part[nt], ah, bl0, bl1);
        mma_tf32(part[nt], al, bh0, bh1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[nt][e];
  }
}

// T = 2I - mu acc on the tile's rows (global row row0 on), the first half of
// an NS step.
template <int kN>
__device__ __forceinline__ void store_t(float* T, const Acc& acc, float mu, int row0) {
  const Lane<kN> ln;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = ln.row(mt, h), j = ln.col(nt);
        float2 v;
        v.x = (row0 + i == j ? 2.f : 0.f) - mu * acc[mt][nt][2 * h];
        v.y = (row0 + i == j + 1 ? 2.f : 0.f) - mu * acc[mt][nt][2 * h + 1];
        *reinterpret_cast<float2*>(T + sw<kN>(i, j)) = v;
      }
}

// X = mu acc, the second half of an NS step.
template <int kN>
__device__ __forceinline__ void store_x(float* X, const Acc& acc, float mu) {
  const Lane<kN> ln;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = make_float2(mu * acc[mt][nt][2 * h], mu * acc[mt][nt][2 * h + 1]);
        *reinterpret_cast<float2*>(X + sw<kN>(ln.row(mt, h), ln.col(nt))) = v;
      }
}

// The largest of v over the CTA, in every thread. warp_max holds WARPS floats.
__device__ __forceinline__ float cta_max(float v, float* warp_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // warp_max is free
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  float mx = warp_max[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, warp_max[w]);
  return mx;
}

}  // namespace qct
