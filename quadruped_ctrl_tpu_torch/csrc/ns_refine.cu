// Newton-Schulz steps on Hopper's wgmma: the warm refinement K6 and the guard
// and warm branch of the guarded warm NS K7 at both tiles, and the plain fp32
// NS K9 on a batch at the 128 tile. One kernel template, ns_refine_kernel<kN,
// kMode>; the mode (RF_REFINE, RF_WARM, RF_PLAIN) is what a system runs.
//
// ns_refine_kernel<128, RF_REFINE> and <256, RF_REFINE> replace the TPU kernel
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_refine (_kernel_refine),
//   npad 128 and 256
// ns_refine_kernel<128, RF_WARM> and <256, RF_WARM>, with K3's kernel as the
// cold branch (qct_ns_inverse_warm[_256] makes both launches), replace
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_warm (_kernel_warm),
//   npad 128 and 256
// ns_refine_kernel<128, RF_PLAIN> replaces
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_blocked (_kernel_blocked),
//   npad 128 (ns_plain.cu has it at 256, and ns_inverse_pallas, K8)
//
// What they compute, as the TPU kernels do. K6: from init X0, in the Jacobi
// scaling of ks (the caller guarantees ||I - ks X0|| < 1), n_quad quadratic
// steps X <- X (2I - K X) with bf16x3 products, then n_hi with fp32-grade
// ones. K7: the guard r0 = max_i sum_j |I - K X0|_ij from the bf16x3
// product K X0 (a NaN row sum counts as infinite); below `guard` the first
// step completes from that product (X = X0 (2I - K X0)), then max(n_quad -
// 1, 0) bf16x3 and n_hi fp32 steps; otherwise the system's flag in
// `tripped` is set and nothing is stored: a second launch, K3's own kernel
// masked to the flagged systems (ns_inverse.cu, ns_cluster.cu), runs the
// cold schedule on them, so a tripped system's result is K3's bit for bit.
// K9: X0 = I / max_i sum_j |K_ij|, then n_hi fp32 steps. bf16x3: both
// operands split into bf16 hi and lo (round to nearest,
// split_pair), hi*hi + hi*lo + lo*hi summed into one fp32 accumulator, per
// 16 k the three passes in that order (the order of the 128-tile core and of
// ns_cluster.cu). fp32: 3xTF32 (hi = tf32(a), lo = tf32(a - hi), cvt.rna),
// the same three passes per 8 k into a fresh accumulator that one fp32 add
// takes into the total every 16 k: one accumulator over all k breaks the
// polish gate at 256 (PERF.md; ns_cluster.cu). The sums run in the K3
// kernels' order (tests/test_torch_ns_inverse.py models it on the CPU), in
// another order than the reference's, so results differ from it by rounding.
//
// Layout. At 128 one CTA owns a system: K, X and T whole. At 256 a cluster
// of 4 CTAs does, CTA q owning rows [64 q, 64 q + 64) of each. Every CTA has
// two warpgroups, and each computes a 64 x 128 output tile with wgmma
// m64n128 (A from registers, B from shared memory): at 128 warpgroup w takes
// rows [64 w, 64 w + 64), at 256 columns [128 w, 128 w + 128) of its CTA's
// slab. X and T, the B operands, are stored in blk<kN>'s chunks of 8 rows
// (mma.cuh), the K-major layout of wgmma's tf32 B operand, so a stage of B
// rows is one contiguous run that is split as it is read: as tf32 into the
// same layout, or as bf16 by pairs of float4 (8 k of one column) into
// bf16's K-major layout (mma.cuh, wgmma_bf16_n128). K, an A operand only,
// is stored row-major (ksw), so that it arrives by 16-byte copies. One step:
//
//   T = 2I - K X    A = K (own rows), B = X: at 256 3/4 of it from the
//                   peers' slabs (ld.shared::cluster), then a cluster barrier
//   X = X T         A = X, B = T the same way, then a barrier before X is
//                   replaced and one more before T is
//
// The product (rf_product). B goes through a ring of two 16 KB stage slots:
// a stage is 16 rows of k (bf16, and tf32 at 128) or 8 (tf32 at 256, so
// that two slots fit beside the three 64 KB slabs: one 16-k run of 3xTF32
// then spans two stages). A stage: the barrier of the threads that share
// it (the CTA at 128, the warpgroup at 256, which stages only its own
// columns), B's loads for a later stage issued (at 128 2 stages ahead; at
// 256 4, over DSMEM, the CTA's own rows too, which measured faster than
// reading them locally), the stage's wgmmas issued; while they run, the next
// stage's A fragments read from the own fp32 tile and split per warp, and
// its B split into the other slot; the wait; the adds. A's fragments and
// the accumulators of an issued wgmma stay put until the wait (wg_hold).
// Each element of B is split once per CTA.
//
// K7's guard. Its product is the first bf16x3 step's K X0, so the guard is
// that step with a check between its two products: each thread sums |I -
// K X0| over its accumulators as it stores T, and the largest row sum is
// taken over the CTA and, at 256, over the cluster's four CTAs by
// distributed shared memory, so every CTA of a system takes the same
// branch. The check puts 112 bytes of spill stores into the 256 instance
// (116 against K6's 4), all in its own code: not inlined (36 bytes) it ran
// at the same speed on the card (PERF.md, section 6). A tripped system
// leaves no last product for the next ks to stream under: its copy is
// exposed. K9's start is formed from K's tile in shared memory as soon as
// it has arrived (exposed too). K7 and K9 keep their row sums and maxima in
// 1 KB beyond K6's layout.
//
// Persistence. The grid is as many CTAs (clusters) as the card holds at
// once, and each walks systems s, s + grid, ... The next system's ks
// streams into K's tile by 16-byte cp.async during the last product X T (K
// is free once K X is done), a few copies a stage; the result goes from the
// accumulators straight to device memory. Only the next init's load is
// exposed: into T's tile by 16-byte copies (T is free then), then
// transposed into X's blk layout in shared memory. Shared memory:
// 3 x 65,536 (K, X, T) + 2 x 16,384 (the ring) = 229,376 bytes a CTA (the
// card allows 232,448), one CTA an SM; no static shared memory.
//
// What bounds it, on an NVIDIA H100 80GB HBM3 (PERF.md, section 6, has the
// measured times; probes/refine_phases.py splits them): the bound is the
// tensor cores' work, 4 npad^3-products a system of 3 passes each (bf16 at
// 989, tf32 at 495 TFLOP/s). The kernel runs at about a third of it: a
// stage is a chain of latencies (its barrier, the wgmma issue, the next
// stage's loads and splits), and at 256 the bf16x3 stages wait on DSMEM
// (12 KB of remote B a stage, ~25 GB/s a CTA with the card full;
// probes/ns_refine_probe.cu). Half of the remote B through L2 instead (~63
// GB/s a CTA), published by each owner in the output's storage, was slower
// on the card: the global loads' issue and the publication cost more than
// the DSMEM they spared. 4-byte copies of ks and init straight into blk (no
// transpose) made the 128-tile kernel ~1.2x slower.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "mma.cuh"
#include "ns_core.cuh"

namespace cg = cooperative_groups;

namespace qct {

constexpr int RF_THREADS = 256;  // two warpgroups
constexpr int RF_SLOT = 4096;    // floats of a ring slot (its hi and lo planes)
constexpr int RF_SCRATCH = 256;  // floats of K7's row sums and maxima, K9's maxima

// What ns_refine_kernel runs on each system (kMode)
constexpr int RF_REFINE = 0;     // K6: n_quad bf16x3 and n_hi fp32 steps from init
constexpr int RF_WARM = 1;       // K7: the guard, then the warm steps or the flag
constexpr int RF_PLAIN = 2;      // K9: n_hi fp32 steps from I / ||K||_inf

// One instance: npad kN.
template <int kN>
struct RefineShape {
  static constexpr int kCtas = kN == 128 ? 1 : 4;                  // CTAs a system
  static constexpr int kRows = kN / kCtas;                         // rows a CTA owns
  static constexpr int kTile = kRows * kN;                         // floats of K, X, T
  static constexpr int kGroup = kCtas == 1 ? RF_THREADS : 128;     // threads sharing a stage
  static constexpr int kCopies = kTile / 4 / RF_THREADS;           // 16-byte copies a tile a thread
  static constexpr size_t kSmemBytes = (3 * kTile + 2 * RF_SLOT) * sizeof(float);
  static_assert(kSmemBytes == 229376, "three 64 KB tiles and two 16 KB slots");
};

// A product's stages: bf16x3 or 3xTF32 at npad kN.
template <int kN, bool kBf16>
struct RefineStage {
  using S = RefineShape<kN>;
  static constexpr int kKB = kBf16 || kN == 128 ? 16 : 8;  // rows of k a stage
  static constexpr int kKG = kBf16 ? 1 : kKB / 8;          // wgmma k-groups a stage
  static constexpr int kStages = kN / kKB;
  static constexpr int kLoads = kKB * 32 / S::kGroup;      // float4 of B a thread a stage
  static constexpr int kDepth = kN == 256 ? 4 : 2;  // stages of B loads in flight
  static constexpr int kPlane = kKB * kN * (kBf16 ? 2 : 4);   // bytes of a hi (lo) plane
  static_assert(2 * kPlane == RF_SLOT * 4 || (kBf16 && kN == 128), "a stage fills its slot");
  static_assert(kStages % kDepth == 0, "whole stages");
};

// Barrier over every thread of the system: the CTA, or the cluster.
template <int kN>
__device__ __forceinline__ void rf_sync() {
  if constexpr (RefineShape<kN>::kCtas == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// Accumulator i of the calling thread: row r of the CTA's tile, column c.
template <int kN>
__device__ __forceinline__ void rf_place(int i, int& r, int& c) {
  const int tid = threadIdx.x, wg = tid >> 7;
  r = (kN == 128 ? 64 * wg : 0) + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2) + 8 * ((i >> 1) & 1);
  c = (kN == 128 ? 0 : 128 * wg) + 8 * (i >> 2) + 2 * (tid & 3) + (i & 1);
}

// Element (r, c) of K's tile: row-major, each row's float4 groups permuted
// by XOR with 8 (r % 4) + 4 (r / 4 % 2), so that a 16-byte copy of 4
// columns lands whole and the A fragments of both products (8 rows, their
// bf16 pairs or tf32 columns) are read free of bank conflicts.
template <int kN>
__device__ __forceinline__ int ksw(int r, int c) {
  return r * kN + (c ^ (8 * (r & 3) + 4 * ((r >> 2) & 1)));
}

// 16-byte copy e of a tile's rows (row-major in device memory) into K's
// layout (kKsw) or row-major: row e / (kN / 4), its float4 e % (kN / 4), so
// a warp reads 512 contiguous bytes.
template <int kN, bool kKsw>
__device__ __forceinline__ void rf_copy(float* tile, const float* __restrict__ src, int e) {
  const int r = e / (kN / 4), c = 4 * (e % (kN / 4));
  cp_async16(tile + (kKsw ? ksw<kN>(r, c) : r * kN + c), src + r * kN + c);
}

template <int kN, bool kKsw>
__device__ __forceinline__ void rf_copy_tile(float* tile, const float* __restrict__ src) {
#pragma unroll
  for (int i = 0; i < RefineShape<kN>::kCopies; ++i)
    rf_copy<kN, kKsw>(tile, src, threadIdx.x + RF_THREADS * i);
}

// X (blk<kN>) from init's rows, row-major in `rows`: each thread moves 4
// rows of one column, 4 loads across a warp's 32 columns and one 16-byte
// store.
template <int kN>
__device__ __forceinline__ void rf_transpose(const float* rows, float* X) {
#pragma unroll 4
  for (int i = 0; i < RefineShape<kN>::kCopies; ++i) {
    const int e = threadIdx.x + RF_THREADS * i, r = 4 * (e / kN), c = e % kN;
    *reinterpret_cast<float4*>(X + blk<kN>(r, c)) =
        make_float4(rows[r * kN + c], rows[(r + 1) * kN + c], rows[(r + 2) * kN + c],
                    rows[(r + 3) * kN + c]);
  }
}

// acc = A @ B for the calling warpgroup's 64 x 128 tile. A is the CTA's own
// tile: K (kAK, in ksw's layout) or X; B (kN x kN) is distributed: its rows
// [kRows p, kRows p + kRows) are the tile at `b_tile` in CTA p. The CTA
// walks k from its own rows on, so each owner serves one peer at a time.
// next_k, when not null: the next system's rows of ks, copied into k_tile a
// few per stage.
template <int kN, bool kBf16, bool kAK>
__device__ __forceinline__ void rf_product(const float* __restrict__ A, const float* b_tile,
                                           float* ring, float (&acc)[64], int q,
                                           const float* __restrict__ next_k, float* k_tile) {
  using S = RefineShape<kN>;
  using P = RefineStage<kN, kBf16>;
  const int tid = threadIdx.x, wg = tid >> 7, w4 = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int col0 = kN == 128 ? 0 : 128 * wg;              // the warpgroup's first column
  const int r0w = (kN == 128 ? 64 * wg : 0) + 16 * w4;    // its warp's first row
  const int gt = kN == 128 ? tid : (tid & 127);           // place among the stage's threads
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  auto row0 = [&](int s) { return (S::kRows * q + P::kKB * s) % kN; };
  // Float offset in B's owner of this thread's float4 l of stage s: tf32, a
  // run of the stage's chunks at the group's columns; bf16, unit u = (column
  // n, chunk h) as two float4, 8 k of column n
  auto src = [&](int s, int l) {
    const int base = (row0(s) % S::kRows >> 3) * 8 * kN;
    if constexpr (kBf16) {
      const int u = gt + S::kGroup * (l >> 1), n = col0 + (u & 127), h = u >> 7;
      return base + h * 8 * kN + (n >> 3) * 64 + (n & 7) * 4 + 32 * (l & 1);
    } else {
      return base + col0 * 8 + 4 * (gt + S::kGroup * l);
    }
  };
  const uint32_t b_own = smem_addr(b_tile);
  auto load = [&](int s, float4 (&v)[P::kLoads]) {
    const int owner = row0(s) / S::kRows;
#pragma unroll
    for (int l = 0; l < P::kLoads; ++l) {
      if constexpr (S::kCtas == 1) {
        v[l] = *reinterpret_cast<const float4*>(b_tile + src(s, l));
      } else {
        v[l] = ld_cluster(map_rank(b_own, owner) + 4 * src(s, l));
      }
    }
  };
  auto stage = [&](int s, const float4 (&v)[P::kLoads]) {
    float* slot = ring + (s & 1) * RF_SLOT;
    if constexpr (kBf16) {
      char* plane = reinterpret_cast<char*>(slot);
#pragma unroll
      for (int m = 0; m < P::kLoads / 2; ++m) {
        const int u = gt + S::kGroup * m, n = col0 + (u & 127), h = u >> 7;
        const float4 a = v[2 * m], b = v[2 * m + 1];
        uint4 hi, lo;
        split_pair(a.x, a.y, hi.x, lo.x);
        split_pair(a.z, a.w, hi.y, lo.y);
        split_pair(b.x, b.y, hi.z, lo.z);
        split_pair(b.z, b.w, hi.w, lo.w);
        const int off = (n >> 3) * 256 + h * 128 + (n & 7) * 16;
        *reinterpret_cast<uint4*>(plane + off) = hi;
        *reinterpret_cast<uint4*>(plane + P::kPlane + off) = lo;
      }
    } else {
#pragma unroll
      for (int l = 0; l < P::kLoads; ++l) {
        uint4 h, o;
        split_tf32(v[l].x, h.x, o.x);
        split_tf32(v[l].y, h.y, o.y);
        split_tf32(v[l].z, h.z, o.z);
        split_tf32(v[l].w, h.w, o.w);
        const int f = col0 * 8 + 4 * (gt + S::kGroup * l);
        *reinterpret_cast<uint4*>(slot + f) = h;
        *reinterpret_cast<uint4*>(slot + P::kPlane / 4 + f) = o;
      }
    }
  };
  // A's fragments of stage s, fp32. bf16 (m16n8k16 layout): an[2 f], an[2 f
  // + 1] are rows g (+ 8) of k 2t, 2t + 1 (+ 8); tf32 (m16n8k8): an[kg][f]
  // rows g (+ 8) of k t (+ 4) of k-group kg
  float an[P::kKG][kBf16 ? 8 : 4];
  auto load_a = [&](int s) {
    const int k0 = row0(s);
#pragma unroll
    for (int kg = 0; kg < P::kKG; ++kg)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = r0w + g + 8 * (f & 1);
        if constexpr (kBf16) {
          const int c = k0 + 2 * t + 8 * (f >> 1);
          if constexpr (kAK) {
            const float2 x = *reinterpret_cast<const float2*>(A + ksw<kN>(r, c));
            an[kg][2 * f] = x.x;
            an[kg][2 * f + 1] = x.y;
          } else {
            an[kg][2 * f] = A[blk<kN>(r, c)];
            an[kg][2 * f + 1] = A[blk<kN>(r, c + 1)];
          }
        } else {
          const int c = k0 + 8 * kg + t + 4 * (f >> 1);
          an[kg][f] = A[kAK ? ksw<kN>(r, c) : blk<kN>(r, c)];
        }
      }
  };
  uint32_t ah[P::kKG][4], al[P::kKG][4];
  float p[kBf16 ? 1 : 64];
  // stage s's wgmmas: bf16x3 into acc; 3xTF32 into the fresh accumulator p,
  // which a run of 16 k starts (scale_d 0): every stage of 16 rows, every
  // even one of 8 (`even`: s is; kDepth is even, so the caller knows it)
  auto issue = [&](int s, bool even) {
    const uint32_t slot = smem_addr(ring + (s & 1) * RF_SLOT);
#pragma unroll
    for (int kg = 0; kg < P::kKG; ++kg)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        if constexpr (kBf16) {
          split_pair(an[kg][2 * f], an[kg][2 * f + 1], ah[kg][f], al[kg][f]);
        } else {
          split_tf32(an[kg][f], ah[kg][f], al[kg][f]);
        }
      }
    wg_fence();
    if constexpr (kBf16) {
      const uint32_t hi = slot + (col0 >> 3) * 256, lo = hi + P::kPlane;
      wgmma_bf16_n128(acc, ah[0], wg_desc(hi), 1);
      wgmma_bf16_n128(acc, ah[0], wg_desc(lo), 1);
      wgmma_bf16_n128(acc, al[0], wg_desc(hi), 1);
    } else {
#pragma unroll
      for (int kg = 0; kg < P::kKG; ++kg) {
        const uint32_t hi = slot + 4 * (col0 * 8 + kg * 8 * kN), lo = hi + P::kPlane;
        const bool fresh = kg == 0 && (P::kKB == 16 || even);
        wgmma_n128(p, ah[kg], wg_desc(hi), !fresh);
        wgmma_n128(p, ah[kg], wg_desc(lo), 1);
        wgmma_n128(p, al[kg], wg_desc(hi), 1);
      }
    }
    wg_commit();
  };
  auto group_bar = [&] {
    if constexpr (S::kCtas == 1) {
      __syncthreads();
    } else {
      wg_bar(wg);
    }
  };
  float4 v[P::kDepth][P::kLoads];
#pragma unroll
  for (int d = 0; d < P::kDepth; ++d) load(d, v[d]);
  load_a(0);
  stage(0, v[0]);
  fence_proxy_async();
  for (int s0 = 0; s0 < P::kStages; s0 += P::kDepth) {
#pragma unroll
    for (int d = 0; d < P::kDepth; ++d) {
      const int s = s0 + d;
      group_bar();  // stage s's slot stored and fenced; stage s - 1's wgmmas done
      if (s + P::kDepth < P::kStages) load(s + P::kDepth, v[d]);
      issue(s, (d & 1) == 0);
      if (next_k != nullptr) {
        for (int c = S::kCopies * s / P::kStages; c < S::kCopies * (s + 1) / P::kStages; ++c)
          rf_copy<kN, true>(k_tile, next_k, tid + RF_THREADS * c);
      }
      if (s + 1 < P::kStages) {
        load_a(s + 1);
        stage(s + 1, v[(d + 1) % P::kDepth]);
        fence_proxy_async();
      }
      wg_wait_all();
#pragma unroll
      for (int kg = 0; kg < P::kKG; ++kg)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          wg_hold_r(ah[kg][f]);
          wg_hold_r(al[kg][f]);
        }
      if constexpr (kBf16) {
#pragma unroll
        for (int i = 0; i < 64; ++i) wg_hold_f(acc[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) wg_hold_f(p[i]);
        if (P::kKB == 16 || (d & 1) == 1) {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] += p[i];
        }
      }
    }
  }
}

// The second half of a quadratic step, X = X T, once T is complete in every
// CTA. q is the CTA's rank in the cluster (0 at 128). In the system's last
// step, next_k streams into K during the product and the result goes
// straight from the accumulators to out (the system's inverse in device
// memory); X is then free once the step returns.
template <int kN, bool kBf16>
__device__ __forceinline__ void rf_finish(float* K, float* X, const float* T, float* ring, int q,
                                          const float* next_k, float* out) {
  using S = RefineShape<kN>;
  float acc[64];
  rf_product<kN, kBf16, false>(X, T, ring, acc, q, next_k, K);
  __syncthreads();  // this CTA's reads of X are done
  if (out != nullptr) {
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      int r, c;
      rf_place<kN>(i, r, c);
      *reinterpret_cast<float2*>(out + (S::kRows * q + r) * kN + c) =
          make_float2(acc[i], acc[i + 1]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    int r, c;
    rf_place<kN>(i, r, c);
    X[blk<kN>(r, c)] = acc[i];
  }
  rf_sync<kN>();  // X complete in every CTA; every read of T done
}

// K7's guard from the calling thread's parts of the row sums of |I - K X0|
// (its 32 accumulators of each of its two rows, rf_place: bit 1 of i):
// whether r0 = max_i sum_j |I - K X0|_ij is below `guard`, the same answer
// in every CTA of the system. The four threads of a row add their parts by
// shuffles, the two warpgroups of a 256-tile row through shared memory; a
// NaN row sum counts as infinite. scr: RF_SCRATCH floats, [0, 128) the
// row sums' parts, [128, 136) the warps' maxima, 136 the CTA's largest row
// sum (read by the peers at 256). Its barriers end every read of K and X
// in the system.
template <int kN>
__device__ __forceinline__ bool rf_guard(float (&part)[2], float* scr, float guard) {
  using S = RefineShape<kN>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the 4 threads of a row hold its 128 columns of the warpgroup
    part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
    part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
  }
  if ((tid & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r, c;
      rf_place<kN>(2 * h, r, c);
      scr[(kN == 128 ? 0 : S::kRows * (tid >> 7)) + r] = part[h];
    }
  }
  __syncthreads();  // every part of the CTA's row sums stored
  float row = 0.f;
  if (tid < S::kRows) {
    row = kN == 128 ? scr[tid] : scr[tid] + scr[S::kRows + tid];
    if (isnan(row)) row = INFINITY;  // fmaxf drops NaN: a NaN start trips
  }
  float r0 = cta_max(row, scr + 128);
  if constexpr (S::kCtas > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) scr[136] = r0;
    cluster.sync();  // every CTA's maximum stored; every read of X done
#pragma unroll
    for (int p = 0; p < S::kCtas; ++p) r0 = fmaxf(r0, *cluster.map_shared_rank(scr + 136, p));
  }
  return r0 < guard;
}

// One quadratic step on the system: T = 2I - K X, then X = X T (rf_finish).
// kGuard and `check` (K7's first step): between the two products, the
// guard on K X (rf_guard); a system that trips returns false at once, with
// X unchanged and nothing stored.
template <int kN, bool kBf16, bool kGuard = false>
__device__ __forceinline__ bool rf_step(float* K, float* X, float* T, float* ring, int q,
                                        const float* next_k, float* out, bool check = false,
                                        float guard = 0.f, float* scr = nullptr) {
  using S = RefineShape<kN>;
  float acc[64], part[2] = {0.f, 0.f};
  rf_product<kN, kBf16, true>(K, X, ring, acc, q, nullptr, nullptr);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    int r, c;
    rf_place<kN>(i, r, c);
    const bool diag = S::kRows * q + r == c;
    T[blk<kN>(r, c)] = (diag ? 2.f : 0.f) - acc[i];
    if constexpr (kGuard) part[(i >> 1) & 1] += fabsf((diag ? 1.f : 0.f) - acc[i]);
  }
  if constexpr (kGuard) {
    if (check && !rf_guard<kN>(part, scr, guard)) return false;
  }
  rf_sync<kN>();  // T complete in every CTA; every read of X and of K done
  rf_finish<kN, kBf16>(K, X, T, ring, q, next_k, out);
  return true;
}

// K9's start X = alpha I (blk's layout), alpha = 1 / max_i sum_j |K_ij|, from
// K's tile (complete in shared memory): row i on thread i, its columns from
// column i on. scr: RF_SCRATCH floats (the warps' maxima).
template <int kN>
__device__ __forceinline__ void rf_plain_start(const float* K, float* X, float* scr) {
  static_assert(RefineShape<kN>::kCtas == 1, "one CTA holds the whole of K");
  const int tid = threadIdx.x;
  float row = 0.f;
  if (tid < kN) {
    for (int j = 0; j < kN; ++j) row += fabsf(K[ksw<kN>(tid, (j + tid) & (kN - 1))]);
  }
  const float alpha = 1.f / cta_max(row, scr);
  for (int f = tid; f < kN * kN; f += RF_THREADS) {
    const int r = f / kN, c = f % kN;
    X[blk<kN>(r, c)] = r == c ? alpha : 0.f;
  }
}

// Dynamic shared memory of instance (kN, kMode): K6's three tiles and ring,
// and for K7 and K9 their scratch.
template <int kN, int kMode>
constexpr size_t rf_smem_bytes() {
  return RefineShape<kN>::kSmemBytes + (kMode == RF_REFINE ? 0 : RF_SCRATCH * sizeof(float));
}

// ks, init (b, kN, kN) -> inv (b, kN, kN). RF_REFINE: n_quad bf16x3 and n_hi
// fp32 quadratic steps from init. RF_WARM: the guard, then below it the warm
// steps from init (n_quad as the TPU kernel's n_wquad), else tripped[s] = 1
// and nothing stored (tripped[s] = 0 for a warm system). RF_PLAIN: n_hi fp32
// steps from I / ||K||_inf (init not read). Grid: kCtas CTAs (one cluster
// at 256) for each system the card runs at once; unit u walks systems u,
// u + units, ...
template <int kN, int kMode>
__global__ void __launch_bounds__(RF_THREADS, 1)
ns_refine_kernel(const float* __restrict__ ks, const float* __restrict__ init,
                 float* __restrict__ inv, int* __restrict__ tripped, int b, int n_quad, int n_hi,
                 float guard) {
  using S = RefineShape<kN>;
  extern __shared__ __align__(128) float smem[];
  float* K = smem;
  float* X = K + S::kTile;
  float* T = X + S::kTile;
  float* ring = T + S::kTile;
  float* scr = ring + 2 * RF_SLOT;  // RF_WARM and RF_PLAIN only
  int q = 0;
  if constexpr (S::kCtas > 1) q = static_cast<int>(cg::this_cluster().block_rank());
  const int unit = blockIdx.x / S::kCtas, units = gridDim.x / S::kCtas;
  const size_t sys_floats = static_cast<size_t>(kN) * kN, rows = static_cast<size_t>(S::kTile) * q;
  if (unit >= b) return;
  rf_copy_tile<kN, true>(K, ks + unit * sys_floats + rows);
  if constexpr (kMode == RF_PLAIN) {
    cp_async_wait_all();
    __syncthreads();  // K complete
    rf_plain_start<kN>(K, X, scr);
  } else {
    rf_copy_tile<kN, false>(T, init + unit * sys_floats + rows);
    cp_async_wait_all();
    __syncthreads();  // init's rows complete in T
    rf_transpose<kN>(T, X);
  }
  rf_sync<kN>();  // K and X complete in every CTA
  for (int sys = unit; sys < b; sys += units) {
    const int next = sys + units;
    const float* next_k = next < b ? ks + next * sys_floats + rows : nullptr;
    float* out = inv + sys * sys_floats;
    // K7: the first of max(n_quad, 1) bf16x3 steps is the guard's (X0
    // (2I - K X0), as the TPU kernel reuses K X0)
    const int nq = kMode == RF_WARM ? max(n_quad, 1) : n_quad, ns = nq + n_hi;
    bool warm = true;
    for (int it = 0; it < ns; ++it) {
      const bool last = it + 1 == ns;
      if (it < nq) {
        warm = rf_step<kN, true, kMode == RF_WARM>(K, X, T, ring, q, last ? next_k : nullptr,
                                                   last ? out : nullptr, it == 0, guard, scr);
        if (!warm) break;
      } else {
        rf_step<kN, false>(K, X, T, ring, q, last ? next_k : nullptr, last ? out : nullptr);
      }
    }
    if constexpr (kMode == RF_WARM) {
      if (q == 0 && threadIdx.x == 0) tripped[sys] = warm ? 0 : 1;
      // a tripped system (K3's launch runs it) leaves K free for the next ks
      if (!warm && next_k != nullptr) rf_copy_tile<kN, true>(K, next_k);
    }
    if (ns == 0) {  // no step: the result is the start itself
      for (int f = threadIdx.x; f < S::kTile; f += RF_THREADS)
        out[rows + f] = X[blk<kN>(f / kN, f % kN)];
      __syncthreads();
      if (next_k != nullptr) rf_copy_tile<kN, true>(K, next_k);
    }
    if (next < b) {
      if constexpr (kMode == RF_PLAIN) {
        cp_async_wait_all();
        __syncthreads();  // the next K complete; every read of X done
        rf_plain_start<kN>(K, X, scr);
      } else {
        if constexpr (S::kCtas > 1) cg::this_cluster().sync();  // the peers' reads of T are done
        rf_copy_tile<kN, false>(T, init + next * sys_floats + rows);
        cp_async_wait_all();
        __syncthreads();  // the next init's rows complete in T
        rf_transpose<kN>(T, X);
      }
    }
    cp_async_wait_all();
    rf_sync<kN>();  // the next K and X complete in every CTA
  }
}

// The launch configuration of instance (kN, kMode) for b systems: as many
// CTAs (4-CTA clusters at 256) as the card holds at once, at most b of them.
template <int kN, int kMode>
cudaError_t refine_config(int b, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                          cudaLaunchAttribute& attr) {
  using S = RefineShape<kN>;
  constexpr size_t smem = rf_smem_bytes<kN, kMode>();
  const auto kernel = ns_refine_kernel<kN, kMode>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(64 * S::kCtas), 1, 1);
  cfg.blockDim = dim3(RF_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = S::kCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = S::kCtas > 1 ? 1 : 0;
  int units = 0;
  if constexpr (S::kCtas > 1) {
    err = cudaOccupancyMaxActiveClusters(&units, kernel, &cfg);
  } else {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, RF_THREADS, smem);
    units = sms * per_sm;
  }
  if (err == cudaSuccess && units < 1) err = cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(static_cast<unsigned>(std::min(b, units) * S::kCtas), 1, 1);
  return err;
}

template <int kN, int kMode>
int launch_refine(const float* ks, const float* init, float* inv, int* tripped, int b, int n_quad,
                  int n_hi, float guard, void* stream) {
  if (b == 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = refine_config<kN, kMode>(b, static_cast<cudaStream_t>(stream), cfg, attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, ns_refine_kernel<kN, kMode>, ks, init, inv, tripped, b, n_quad,
                             n_hi, guard);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace qct

// K3's kernel masked to the flagged systems: ns_inverse.cu and ns_cluster.cu.
extern "C" int qct_ns_inverse_scaled_masked(const float* ks, float* inv, const int* tripped, int b,
                                            const float* mus, int n_scaled, int n_quad, int n_hi,
                                            void* stream);
extern "C" int qct_ns_inverse_scaled_masked_256(const float* ks, float* inv, const int* tripped,
                                                int b, const float* mus, int n_scaled,
                                                int n_quad, int n_hi, void* stream);

// C entry points (loaded with ctypes). Each returns the first failed launch's
// cudaError_t (0 when every launch went); the caller checks bounds and types.
extern "C" int qct_ns_inverse_refine(const float* ks, const float* init, float* inv, int b,
                                     int n_quad, int n_hi, void* stream) {
  return qct::launch_refine<128, qct::RF_REFINE>(ks, init, inv, nullptr, b, n_quad, n_hi, 0.f,
                                                 stream);
}

extern "C" int qct_ns_inverse_refine_256(const float* ks, const float* init, float* inv, int b,
                                         int n_quad, int n_hi, void* stream) {
  return qct::launch_refine<256, qct::RF_REFINE>(ks, init, inv, nullptr, b, n_quad, n_hi, 0.f,
                                                 stream);
}

// K9 at the 128 tile: `iters` fp32 steps from I / ||K||_inf.
extern "C" int qct_ns_inverse_plain(const float* ks, float* inv, int b, int iters, void* stream) {
  return qct::launch_refine<128, qct::RF_PLAIN>(ks, nullptr, inv, nullptr, b, 0, iters, 0.f,
                                                stream);
}

// K7's first launch alone (npad 128 or 256): the guard and the warm branch,
// tripped (b int32) set per system. For timing the two launches apart.
extern "C" int qct_ns_warm_guarded(const float* ks, const float* init, float* inv, int* tripped,
                                   int b, int n_wquad, int n_whi, float guard, int npad,
                                   void* stream) {
  if (npad == 128)
    return qct::launch_refine<128, qct::RF_WARM>(ks, init, inv, tripped, b, n_wquad, n_whi, guard,
                                                 stream);
  if (npad == 256)
    return qct::launch_refine<256, qct::RF_WARM>(ks, init, inv, tripped, b, n_wquad, n_whi, guard,
                                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7: the guard and the warm branch, then K3's cold schedule (mus, n_scaled,
// n_quad, n_hi) on the systems whose guard tripped, both on `stream`.
extern "C" int qct_ns_inverse_warm(const float* ks, const float* init, float* inv, int* tripped,
                                   int b, const float* mus, int n_scaled, int n_quad, int n_hi,
                                   int n_wquad, int n_whi, float guard, void* stream) {
  if (n_scaled > qct::NS_MAX_MUS) return static_cast<int>(cudaErrorInvalidValue);
  int err = qct_ns_warm_guarded(ks, init, inv, tripped, b, n_wquad, n_whi, guard, 128, stream);
  if (err == 0)
    err = qct_ns_inverse_scaled_masked(ks, inv, tripped, b, mus, n_scaled, n_quad, n_hi, stream);
  return err;
}

extern "C" int qct_ns_inverse_warm_256(const float* ks, const float* init, float* inv,
                                       int* tripped, int b, const float* mus, int n_scaled,
                                       int n_quad, int n_hi, int n_wquad, int n_whi, float guard,
                                       void* stream) {
  if (n_scaled > qct::NS_MAX_MUS) return static_cast<int>(cudaErrorInvalidValue);
  int err = qct_ns_warm_guarded(ks, init, inv, tripped, b, n_wquad, n_whi, guard, 256, stream);
  if (err == 0)
    err = qct_ns_inverse_scaled_masked_256(ks, inv, tripped, b, mus, n_scaled, n_quad, n_hi,
                                           stream);
  return err;
}
