// The Newton-Schulz product on the tensor cores, the parts the kernels share
// (ns_core.cuh at 128, one block a system; ns_refine.cu at both tiles, a
// 4-CTA cluster a system at 256; ns_plain.cu, the plain fp32 NS on
// clusters): the bf16
// and tf32 hi/lo splits, mma.sync m16n8k16 bf16 and m16n8k8 tf32,
// ldmatrix.trans, the distributed shared memory loads, the swizzled fp32
// tiles and bf16 staging planes, wgmma (tf32 for the plain NS, tf32 and bf16
// for the warm refinement of ns_refine.cu), cp.async, and one 16-row
// chunk of k of a product for a warp's 32 x 64 output tile, with its
// epilogues. A kN-column output is computed by 8 warps (256 threads), kN /
// 64 warp tiles across.
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

// The shared::cluster address of `addr` (a shared::cta address) in CTA `rank`
// of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// A float4 of distributed shared memory (an address from map_rank).
__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// wgmma, tf32 (ns_plain.cu): a warpgroup's m64nNk8 product with A from
// registers (each warp 16 rows, in the m16n8k8 A fragment layout) and B from
// shared memory, K-major without swizzle: element (k, n) of an 8-row chunk of
// k at byte (n / 8) 256 + (k / 4) 128 + (n % 8) 16 + (k % 4) 4 from the
// chunk's start (8 x 16-byte core matrices; the leading, K, byte offset 128,
// the stride, N, byte offset 256; probes/ns_plain_probe.cu checks this
// layout exactly). The accumulator: d[4 j + e] holds row 16 warp + g +
// 8 (e / 2), column 8 j + 2 t + e % 2 of the warpgroup's tile.
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr, uint32_t lbo = 128,
                                            uint32_t sbo = 256) {
  return static_cast<uint64_t>((saddr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Empty asm that reads and writes r: placed after wg_wait_all(), it keeps a
// register that an in-flight wgmma reads (A's fragment) or writes (its
// accumulator) from being reused, or read, before the wait.
__device__ __forceinline__ void wg_hold_f(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void wg_hold_r(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// A barrier over the 128 threads of warpgroup wg (named barrier 1 + wg):
// the warpgroups of a block then run their stages out of step.
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// Orders this thread's generic stores to shared memory before the async
// proxy's reads of it (wgmma's B operand).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// d (+)= a b for the warpgroup's m64n128k8 tile (tf32, A from registers, B from
// shared memory by its descriptor); scale_d 0: d = a b.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

// d (+)= a b for the warpgroup's m64n32k8 tile (tf32, A from registers, B from
// shared memory by its descriptor); scale_d 0: d = a b.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

// d (+)= a b for the warpgroup's m64n16k8 tile (tf32, A from registers, B from
// shared memory by its descriptor); scale_d 0: d = a b.
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

// d (+)= a b for the warpgroup's m64n128k16 tile in bf16 (ns_refine.cu): A
// from registers (each warp 16 rows, in the m16n8k16 A fragment layout:
// a0, a1 rows g, g + 8 of k 2t, 2t + 1, a2, a3 the same of k 2t + 8, 2t + 9,
// the lower k in the low half), B from shared memory K-major without
// swizzle: element (k, n) at byte (n / 8) 256 + (k / 8) 128 + (n % 8) 16 +
// (k % 8) 2 (8 x 16-byte core matrices, as wg_desc's tf32 layout; checked
// exactly by probes/ns_refine_probe.cu); the accumulator as wgmma_n128's.
// scale_d 0: d = a b.
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

// One 16-byte asynchronous copy from device memory into shared memory, both
// addresses 16-byte aligned (ns_refine.cu streams the next system's tiles
// with it); cp_async_wait_all waits for the calling thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Element (r, c) of a tile kW floats wide, in chunks of 8 rows laid out as
// wgmma's K-major tf32 B operand (wg_desc): (r / 8) 8 kW + (c / 8) 64 +
// (r % 8 / 4) 32 + (c % 8) 4 + r % 4 (ns_plain.cu, ns_refine.cu).
template <int kW>
__device__ __forceinline__ int blk(int r, int c) {
  return (r >> 3) * (8 * kW) + (c >> 3) * 64 + ((r >> 2) & 1) * 32 + (c & 7) * 4 + (r & 3);
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

// T = 2I - mu acc, the first half of an NS step.
template <int kN>
__device__ __forceinline__ void store_t(float* T, const Acc& acc, float mu) {
  const Lane<kN> ln;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = ln.row(mt, h), j = ln.col(nt);
        float2 v;
        v.x = (i == j ? 2.f : 0.f) - mu * acc[mt][nt][2 * h];
        v.y = (i == j + 1 ? 2.f : 0.f) - mu * acc[mt][nt][2 * h + 1];
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
