// Newton-Schulz steps on Hopper's wgmma: the warm refinement K6 and the guard
// and warm branch of the guarded warm NS K7 at both tiles, the plain fp32 NS
// K9 on a batch at the 128 tile, and the scaled NS K3 and its fused build K2
// at the 256 tile. One kernel template, ns_refine_kernel<kN, kMode>; the mode
// (RF_REFINE, RF_WARM, RF_PLAIN, RF_SCALED, RF_BUILD) is what a system runs.
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
// ns_refine_kernel<256, RF_SCALED> replaces
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_scaled (_kernel_scaled_il),
//   npad 256 (ns_inverse.cu has it at 128); masked to the systems whose flag
//   in `tripped` is set, it is K7/256's cold branch
// ns_refine_kernel<256, RF_BUILD>, and on systems of at most 192 variables
// ns_refine_kernel<192, RF_BUILD>, replace
//   quadruped_ctrl_tpu/ops/ns_inverse.py: ns_inverse_pallas_scaled_build
//   (_kernel_scaled_build_il, npad 256, emit_ks False)
//
// What they compute, as the TPU kernels do. K6: from init X0, in the Jacobi
// scaling of ks (the caller guarantees ||I - ks X0|| < 1), n_quad quadratic
// steps X <- X (2I - K X) with bf16x3 products, then n_hi with fp32-grade
// ones. K7: the guard r0 = max_i sum_j |I - K X0|_ij from the bf16x3
// product K X0 (a NaN row sum counts as infinite); below `guard` the first
// step completes from that product (X = X0 (2I - K X0)), then max(n_quad -
// 1, 0) bf16x3 and n_hi fp32 steps; otherwise the system's flag in
// `tripped` is set and nothing is stored: a second launch, K3's kernel
// masked to the flagged systems (ns_inverse.cu's at 128, RF_SCALED here at
// 256), runs the cold schedule on them, so a tripped system's result is
// K3's bit for bit. K9: X0 = I / max_i sum_j |K_ij|, then n_hi fp32 steps.
// K3: the same X0, then for each mu of mu_schedule(a0, n_scaled) the scaled
// step X <- mu X (2I - mu K X) in bf16x3, n_quad quadratic bf16x3 steps and
// n_hi fp32 steps. K2: K = hp + blockdiag3(g9), d = rsqrt(max(diag K,
// 1e-30)), ks = D K D built in K's tile, then K3's schedule; inv and d_row
// out, no ks. bf16x3: both operands split into bf16 hi and lo (round to
// nearest, split_pair), hi*hi + hi*lo + lo*hi summed into one fp32
// accumulator, per 16 k the three passes in that order (the order of the
// 128-tile core). fp32: 3xTF32 (hi = tf32(a), lo = tf32(a - hi), cvt.rna),
// the same three passes per 8 k into a fresh accumulator that one fp32 add
// takes into the total every 16 k: one accumulator over all k breaks the
// polish gate at 256 (PERF.md, section 6). The sums run in the order
// tests/test_torch_ns_inverse.py models on the CPU (slabs of 64 rows at 256,
// each walking k from its own rows in runs of 16), in another order than
// the reference's, so results differ from it by rounding.
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
// is stored row-major (ksw), so that it arrives by 16-byte copies.
//
// K2 on a system of at most 192 variables (3 nblk; hp is diagonal beyond,
// the identity as the callers pad) runs on ns_refine_kernel<192, RF_BUILD>: a cluster of 3 CTAs over
// the 256 tile's leading 192 rows and columns, whose pad the 4-CTA
// instance only multiplies by zeros (its CTA 3 holds nothing else). Each
// warpgroup computes 64 x 96 with wgmma m64n96; device memory keeps the 256
// tile's strides (kLd). Every nonzero term is summed in the 4-CTA
// instance's order (zeros added to a sum leave it as it is), and the pad
// (rf_pad) gets what the 4-CTA instance's steps leave there: zeros off its
// diagonal, and each diagonal entry's own NS steps, replayed through the
// same passes on the tensor cores (rf_pad_diag); alpha takes the pad's rows
// into its maximum. So inv and d_row are the 4-CTA instance's bit for bit,
// over the whole tile. One step:
//
//   T = 2I - mu K X   A = K (own rows), B = X: at 256 3/4 of it from the
//                     peers' slabs (ld.shared::cluster), then a cluster barrier
//   X = mu X T        A = X, B = T the same way, then a barrier before X is
//                     replaced and one more before T is
//
// (mu = 1 but in K3's scaled steps: 1.0f * v is v, and 2 - 1.0f * v rounds as
// 2 - v, fused or not, so K6, K7 and K9 are unchanged by it.)
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
// Each element of B is split once per CTA. At 192 a stage is 16 rows of
// both kinds (two 24 KB slots), 3 float4 of B a thread, each split alone
// (96 columns a warpgroup hold no whole pairs of them a thread).
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
// exposed.
//
// The cold start (K9, K3, K2; rf_cold_start): X0 = alpha I, alpha = 1 / max_i
// sum_j |K_ij|, from K's tile as soon as it is complete in shared memory:
// each CTA sums its own rows, and at 256 the largest sum goes over the
// cluster's four CTAs by DSMEM, as the guard's does (exposed, ~1 us a system
// against ~250 us of K3's steps). K2's build (rf_build) runs just before it,
// in K's tile: hp's rows stream in as ks's do; every CTA computes all 256
// d from hp's diagonal (device memory) and g9's, adds g9's 3 x 3 blocks to
// its rows and scales them by D in place, and stores its 64 of d_row. K7,
// K9 and K3 keep their row sums, maxima, the mu table and the masked walk's
// counts in 1 KB beyond K6's layout, K2 its d in 1 KB more.
//
// Persistence. The grid is as many CTAs (clusters) as the card holds at
// once, and each walks systems s, s + grid, ...; a masked K3 (K7's cold
// branch) walks the flagged systems of rank s, s + grid, ... among the
// flagged ones (rf_flagged: 256 flags a block-wide scan, so every unit gets
// its share of the tripped systems wherever they lie). The next system's ks
// (hp) streams into K's tile by 16-byte cp.async during the last product X
// T (K is free once K X is done), a few copies a stage; the result goes from
// the accumulators straight to device memory. Only the next init's load is
// exposed: into T's tile by 16-byte copies (T is free then), then
// transposed into X's blk layout in shared memory. Shared memory:
// 3 x 65,536 (K, X, T) + 2 x 16,384 (the ring) = 229,376 bytes a CTA, with
// the scratch 230,400 and K2's d 231,424 (the card allows 232,448), one CTA
// an SM; no static shared memory. At 192: 3 x 49,152 + 2 x 24,576 = 196,608,
// with the scratch, d and the pad's diagonals 199,168.
//
// What bounds it, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6,
// has the measured times; probes/refine_phases.py splits them): the bound is
// the tensor cores' work, 2 npad^3-products a step of 3 passes each (bf16 at
// 989, tf32 at 495 TFLOP/s). The kernel runs at about a third of it at 128
// and 0.27-0.29 at 256 (K2, K3, K6): a stage is a chain of latencies (its
// barrier, the wgmma issue, then the next stage's A fragments and B split
// and stored, ~600 of a bf16x3 stage's ~920 clocks at 256), beside 64 KB
// of shared-memory traffic a CTA a stage at 256, counted from the shapes
// (24 KB the wgmmas' reads of B's planes, 16 KB the staging's stores, 8 KB
// A's fragments, 16 KB the peers' DSMEM reads of the tile), ~500 clocks at
// 128 bytes a clock. The remote bytes alone are not the bound: loading one
// peer's rows fewer (128 KB a product in place of 192 KB) took 1.4% off
// K3/256, and pushing them with cp.async.bulk moves them only ~1.25x faster
// than the pulls, ~1.03x once the receiver reads them back from its own
// shared memory (probes/dsmem_push_probe.cu). Half of the remote B through L2
// instead (~63 GB/s a CTA), published by each owner in the output's
// storage, was slower on the card: the global loads' issue and the
// publication cost more than the DSMEM they spared. 4-byte copies of ks and
// init straight into blk (no transpose) made the 128-tile kernel ~1.2x
// slower.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "mma.cuh"
#include "ns_core.cuh"

namespace cg = cooperative_groups;

namespace qct {

constexpr int RF_THREADS = 256;  // two warpgroups
// floats of the scratch beyond K6's layout (K7, K9, K3, K2): [0, 128) the
// guard's row sums, [128, 136) warps' maxima, 136 the CTA's maximum (read by
// the peers), [144, 153) the masked walk's counts, [160, 176) the mu table
constexpr int RF_SCRATCH = 256;
constexpr int RF_MAX = 136, RF_WALK = 144, RF_MU = 160;

// What ns_refine_kernel runs on each system (kMode)
constexpr int RF_REFINE = 0;     // K6: n_quad bf16x3 and n_hi fp32 steps from init
constexpr int RF_WARM = 1;       // K7: the guard, then the warm steps or the flag
constexpr int RF_PLAIN = 2;      // K9: n_hi fp32 steps from I / ||K||_inf
constexpr int RF_SCALED = 3;     // K3: n_scaled mu-scaled, n_quad, n_hi steps from I / ||K||_inf
constexpr int RF_BUILD = 4;      // K2: ks = D (hp + blockdiag3(g9)) D in K's tile, then K3's steps

// A launch's arguments (by value).
struct RfArgs {
  const float* ks;    // (b, kN, kN): ks, or hp (RF_BUILD)
  const float* init;  // (b, kN, kN): RF_REFINE, RF_WARM
  float* inv;         // (b, kN, kN)
  int* tripped;       // (b): RF_WARM's flags; RF_SCALED runs the flagged systems alone, if set
  const float* g9;    // (b, 9, nblk): RF_BUILD
  float* d_row;       // (b, kN): RF_BUILD
  int b, nblk, n_scaled, n_quad, n_hi;
  float guard;        // RF_WARM
  float mu[NS_MAX_MUS];
};

// One instance: npad kN. kN 192 is K2 on the leading 192 rows and columns
// of the 256 tile (systems of at most 192 variables): the 256 tile's strides
// in device memory (kLd), its pad written apart (kPad, rf_pad).
template <int kN>
struct RefineShape {
  static constexpr int kCtas = kN == 128 ? 1 : kN / 64;            // CTAs a system
  static constexpr int kRows = kN / kCtas;                         // rows a CTA owns
  static constexpr int kLd = kN == 128 ? 128 : 256;                // floats a row in device memory
  static constexpr bool kPad = kLd != kN;
  static constexpr int kTile = kRows * kN;                         // floats of K, X, T
  static constexpr int kCols = kCtas == 1 ? kN : kN / 2;           // a warpgroup's output columns
  static constexpr int kAcc = kCols / 2;                           // its accumulators a thread
  static constexpr int kGroup = kCtas == 1 ? RF_THREADS : 128;     // threads sharing a stage
  static constexpr int kCopies = kTile / 4 / RF_THREADS;           // 16-byte copies a tile a thread
  static constexpr int kSlot = kPad ? 6144 : 4096;                 // floats of a ring slot (hi, lo)
  static constexpr size_t kSmemBytes = (3 * kTile + 2 * kSlot) * sizeof(float);
  static_assert(kPad || kSmemBytes == 229376, "three 64 KB tiles and two 16 KB slots");
};

// A product's stages: bf16x3 or 3xTF32 at npad kN.
template <int kN, bool kBf16>
struct RefineStage {
  using S = RefineShape<kN>;
  static constexpr int kKB = kBf16 || kN != 256 ? 16 : 8;  // rows of k a stage
  static constexpr int kKG = kBf16 ? 1 : kKB / 8;          // wgmma k-groups a stage
  static constexpr int kStages = kN / kKB;
  static constexpr int kLoads = kKB * S::kCols / 4 / S::kGroup;  // float4 of B a thread a stage
  static constexpr int kDepth = kN == 256 ? 4 : 2;  // stages of B loads in flight
  static constexpr int kPlane = kKB * kN * (kBf16 ? 2 : 4);   // bytes of a hi (lo) plane
  static_assert(2 * kPlane == S::kSlot * 4 || (kBf16 && kN != 256), "a stage fills its slot");
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
  c = (kN == 128 ? 0 : RefineShape<kN>::kCols * wg) + 8 * (i >> 2) + 2 * (tid & 3) + (i & 1);
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
  cp_async16(tile + (kKsw ? ksw<kN>(r, c) : r * kN + c), src + r * RefineShape<kN>::kLd + c);
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

// wgmma at the warpgroup's width (kAcc accumulators a thread): m64n128, or
// m64n96 in the 192 instance.
template <bool kBf16, int kAcc>
__device__ __forceinline__ void rf_wgmma(float (&d)[kAcc], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  if constexpr (kAcc == 64 && kBf16) wgmma_bf16_n128(d, a, desc, scale_d);
  if constexpr (kAcc == 64 && !kBf16) wgmma_n128(d, a, desc, scale_d);
  if constexpr (kAcc == 48 && kBf16) wgmma_bf16_n96(d, a, desc, scale_d);
  if constexpr (kAcc == 48 && !kBf16) wgmma_n96(d, a, desc, scale_d);
}

// acc = A @ B for the calling warpgroup's 64 x kCols tile. A is the CTA's own
// tile: K (kAK, in ksw's layout) or X; B (kN x kN) is distributed: its rows
// [kRows p, kRows p + kRows) are the tile at `b_tile` in CTA p. The CTA
// walks k from its own rows on, so each owner serves one peer at a time.
// next_k, when not null: the next system's rows of ks, copied into k_tile a
// few per stage.
template <int kN, bool kBf16, bool kAK>
__device__ __forceinline__ void rf_product(const float* __restrict__ A, const float* b_tile,
                                           float* ring, float (&acc)[RefineShape<kN>::kAcc],
                                           int q,
                                           const float* __restrict__ next_k, float* k_tile) {
  using S = RefineShape<kN>;
  using P = RefineStage<kN, kBf16>;
  const int tid = threadIdx.x, wg = tid >> 7, w4 = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int col0 = kN == 128 ? 0 : S::kCols * wg;         // the warpgroup's first column
  const int r0w = (kN == 128 ? 64 * wg : 0) + 16 * w4;    // its warp's first row
  const int gt = kN == 128 ? tid : (tid & 127);           // place among the stage's threads
#pragma unroll
  for (int i = 0; i < S::kAcc; ++i) acc[i] = 0.f;
  auto row0 = [&](int s) { return (S::kRows * q + P::kKB * s) % kN; };
  // At 192 (kPad) the float offset of this thread's float4 l from the
  // stage's first row, in B's owner and, tf32, in the slot: f = gt + kGroup
  // l; bf16, 4 k of one column, f = (chunk u / kCols, column u % kCols, half
  // f % 2 of the chunk), u = f / 2; tf32, the group's run of each chunk
  auto pad_off = [&](int l) {
    const int f = gt + S::kGroup * l;
    if constexpr (kBf16) {
      const int u = f >> 1, n = col0 + u % S::kCols;
      return u / S::kCols * 8 * kN + (n >> 3) * 64 + (n & 7) * 4 + 32 * (f & 1);
    } else {
      return f / (2 * S::kCols) * 8 * kN + col0 * 8 + 4 * (f % (2 * S::kCols));
    }
  };
  // Float offset in B's owner of this thread's float4 l of stage s: tf32, a
  // run of the stage's chunks at the group's columns; bf16, unit u = (column
  // n, chunk h) as two float4, 8 k of column n
  auto src = [&](int s, int l) {
    const int base = (row0(s) % S::kRows >> 3) * 8 * kN;
    if constexpr (S::kPad) {
      return base + pad_off(l);
    } else if constexpr (kBf16) {
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
    float* slot = ring + (s & 1) * S::kSlot;
    if constexpr (kBf16 && S::kPad) {  // each float4 into 8 bytes of each plane
      char* plane = reinterpret_cast<char*>(slot);
#pragma unroll
      for (int l = 0; l < P::kLoads; ++l) {
        const int f = gt + S::kGroup * l, u = f >> 1, n = col0 + u % S::kCols;
        uint2 hi, lo;
        split_pair(v[l].x, v[l].y, hi.x, lo.x);
        split_pair(v[l].z, v[l].w, hi.y, lo.y);
        const int off = (n >> 3) * 256 + u / S::kCols * 128 + (n & 7) * 16 + 8 * (f & 1);
        *reinterpret_cast<uint2*>(plane + off) = hi;
        *reinterpret_cast<uint2*>(plane + P::kPlane + off) = lo;
      }
    } else if constexpr (kBf16) {
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
        const int f = S::kPad ? pad_off(l) : col0 * 8 + 4 * (gt + S::kGroup * l);
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
  float p[kBf16 ? 1 : S::kAcc];
  // stage s's wgmmas: bf16x3 into acc; 3xTF32 into the fresh accumulator p,
  // which a run of 16 k starts (scale_d 0): every stage of 16 rows, every
  // even one of 8 (`even`: s is; kDepth is even, so the caller knows it)
  auto issue = [&](int s, bool even) {
    const uint32_t slot = smem_addr(ring + (s & 1) * S::kSlot);
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
      rf_wgmma<true>(acc, ah[0], wg_desc(hi), 1);
      rf_wgmma<true>(acc, ah[0], wg_desc(lo), 1);
      rf_wgmma<true>(acc, al[0], wg_desc(hi), 1);
    } else {
#pragma unroll
      for (int kg = 0; kg < P::kKG; ++kg) {
        const uint32_t hi = slot + 4 * (col0 * 8 + kg * 8 * kN), lo = hi + P::kPlane;
        const bool fresh = kg == 0 && (P::kKB == 16 || even);
        rf_wgmma<false>(p, ah[kg], wg_desc(hi), !fresh);
        rf_wgmma<false>(p, ah[kg], wg_desc(lo), 1);
        rf_wgmma<false>(p, al[kg], wg_desc(hi), 1);
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
        for (int i = 0; i < S::kAcc; ++i) wg_hold_f(acc[i]);
      } else {
#pragma unroll
        for (int i = 0; i < S::kAcc; ++i) wg_hold_f(p[i]);
        if (P::kKB == 16 || (d & 1) == 1) {
#pragma unroll
          for (int i = 0; i < S::kAcc; ++i) acc[i] += p[i];
        }
      }
    }
  }
}

// The second half of a step, X = mu X T, once T is complete in every CTA. q
// is the CTA's rank in the cluster (0 at 128). In the system's last step,
// next_k streams into K during the product and the result goes straight
// from the accumulators to out (the system's inverse in device memory); X
// is then free once the step returns.
template <int kN, bool kBf16>
__device__ __forceinline__ void rf_finish(float* K, float* X, const float* T, float* ring, int q,
                                          const float* next_k, float* out, float mu) {
  using S = RefineShape<kN>;
  float acc[S::kAcc];
  rf_product<kN, kBf16, false>(X, T, ring, acc, q, next_k, K);
  __syncthreads();  // this CTA's reads of X are done
  if (out != nullptr) {
#pragma unroll
    for (int i = 0; i < S::kAcc; i += 2) {
      int r, c;
      rf_place<kN>(i, r, c);
      *reinterpret_cast<float2*>(out + (S::kRows * q + r) * S::kLd + c) =
          make_float2(mu * acc[i], mu * acc[i + 1]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < S::kAcc; ++i) {
    int r, c;
    rf_place<kN>(i, r, c);
    X[blk<kN>(r, c)] = mu * acc[i];
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
    if (tid == 0) scr[RF_MAX] = r0;
    cluster.sync();  // every CTA's maximum stored; every read of X done
#pragma unroll
    for (int p = 0; p < S::kCtas; ++p) r0 = fmaxf(r0, *cluster.map_shared_rank(scr + RF_MAX, p));
  }
  return r0 < guard;
}

// Entry (i, j) of T = 2I - mu K X from entry v of K X, two_i 2 on the
// diagonal, else 0; rf_pad_diag rounds the pad's entry by it too.
__device__ __forceinline__ float rf_t(float two_i, float mu, float v) { return two_i - mu * v; }

// One step on the system: T = 2I - mu K X, then X = mu X T (rf_finish); mu
// is 1 but in K3's scaled steps. kGuard and `check` (K7's first step):
// between the two products, the guard on K X (rf_guard); a system that
// trips returns false at once, with X unchanged and nothing stored.
template <int kN, bool kBf16, bool kGuard = false>
__device__ __forceinline__ bool rf_step(float* K, float* X, float* T, float* ring, int q,
                                        const float* next_k, float* out, float mu,
                                        bool check = false, float guard = 0.f,
                                        float* scr = nullptr) {
  using S = RefineShape<kN>;
  float acc[S::kAcc], part[2] = {0.f, 0.f};
  rf_product<kN, kBf16, true>(K, X, ring, acc, q, nullptr, nullptr);
#pragma unroll
  for (int i = 0; i < S::kAcc; ++i) {
    int r, c;
    rf_place<kN>(i, r, c);
    const bool diag = S::kRows * q + r == c;
    T[blk<kN>(r, c)] = rf_t(diag ? 2.f : 0.f, mu, acc[i]);
    if constexpr (kGuard) part[(i >> 1) & 1] += fabsf((diag ? 1.f : 0.f) - acc[i]);
  }
  if constexpr (kGuard) {
    if (check && !rf_guard<kN>(part, scr, guard)) return false;
  }
  rf_sync<kN>();  // T complete in every CTA; every read of X and of K done
  rf_finish<kN, kBf16>(K, X, T, ring, q, next_k, out, mu);
  return true;
}

// The cold start X = alpha I (blk's layout) of K9, K3 and K2, alpha = 1 /
// max_i sum_j |K_ij|, from K's tile (complete in shared memory): the CTA's
// row i on thread i, its columns from column i on; at 256 the largest row
// sum over the cluster's four CTAs by DSMEM (every CTA of the system then
// has the same alpha), at 192 over its three and the pad's rows, whose sums
// are their diagonal entries (pad: the pad's ks diagonal, kLd - kN floats,
// folded in by every CTA). Its cluster barrier also ends every peer's reads
// of this CTA's T and X from the system before. scr: RF_SCRATCH floats.
// Returns alpha.
template <int kN>
__device__ __forceinline__ float rf_cold_start(const float* K, float* X, float* scr, int q,
                                               const float* pad = nullptr) {
  using S = RefineShape<kN>;
  const int tid = threadIdx.x;
  float row = 0.f;
  if (tid < S::kRows) {
    for (int j = 0; j < kN; ++j) {
      if constexpr (S::kPad) {
        const int c = j + tid;
        row += fabsf(K[ksw<kN>(tid, c < kN ? c : c - kN)]);
      } else {
        row += fabsf(K[ksw<kN>(tid, (j + tid) & (kN - 1))]);
      }
    }
    if constexpr (S::kPad) {
      static_assert(S::kLd - kN == S::kRows, "a pad row a thread");
      row = fmaxf(row, fabsf(pad[tid]));
    }
  }
  float mx = cta_max(row, scr + 128);
  if constexpr (S::kCtas > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) scr[RF_MAX] = mx;
    cluster.sync();  // every CTA's maximum stored
#pragma unroll
    for (int p = 0; p < S::kCtas; ++p) mx = fmaxf(mx, *cluster.map_shared_rank(scr + RF_MAX, p));
  }
  const float alpha = 1.f / mx;
  // 4 rows of one column a 16-byte store, as rf_transpose
#pragma unroll 4
  for (int i = 0; i < S::kCopies; ++i) {
    const int e = tid + RF_THREADS * i, r = 4 * (e / kN), c = e % kN, d = c - S::kRows * q - r;
    *reinterpret_cast<float4*>(X + blk<kN>(r, c)) =
        make_float4(d == 0 ? alpha : 0.f, d == 1 ? alpha : 0.f, d == 2 ? alpha : 0.f,
                    d == 3 ? alpha : 0.f);
  }
  return alpha;
}

// K2's build in K's tile, which holds the CTA's rows of hp (row-major, ksw):
// d = rsqrt(max(diag K, 1e-30)) of all kLd rows into d (kLd floats), from
// hp's diagonal in device memory and g9's diagonal entries, then the tile
// replaced by (hp + blockdiag3(g9)) d_r d_c, and the CTA's entries of d_row
// stored. hp, g and d_row are the system's (rows kLd floats apart). At 192
// (kPad) also the pad's ks diagonal into pad and, by the last CTA, its
// d_row. The caller's barrier must come before any other thread reads K.
template <int kN>
__device__ __forceinline__ void rf_build(float* K, float* d, const float* __restrict__ hp,
                                         const float* __restrict__ g, int nblk,
                                         float* __restrict__ d_row, int q,
                                         float* pad = nullptr) {
  using S = RefineShape<kN>;
  const int tid = threadIdx.x;
  for (int i = tid; i < S::kLd; i += RF_THREADS) {
    float v = hp[static_cast<size_t>(i) * S::kLd + i];
    const int blk = i / 3;
    if (blk < nblk) v += g[(3 * (i % 3) + i % 3) * nblk + blk];
    d[i] = 1.f / sqrtf(fmaxf(v, 1e-30f));
    if constexpr (S::kPad) {
      if (i >= kN) pad[i - kN] = v * d[i] * d[i];  // as the tile's entries below
    }
  }
  __syncthreads();  // d complete
  if (tid < S::kRows) d_row[S::kRows * q + tid] = d[S::kRows * q + tid];
  if constexpr (S::kPad) {
    if (q == S::kCtas - 1 && tid < S::kLd - kN) d_row[kN + tid] = d[kN + tid];
  }
  for (int f = tid; f < S::kTile; f += RF_THREADS) {  // column f % kN of row f / kN
    const int i = f / kN, c = f % kN, r = S::kRows * q + i, blk = c / 3;
    float v = K[ksw<kN>(i, c)];
    if (r / 3 == blk && blk < nblk) v += g[(3 * (r % 3) + c % 3) * nblk + blk];
    K[ksw<kN>(i, c)] = v * d[r] * d[c];
  }
}

// The value the 4-CTA instance leaves on pad diagonal entry 8 w + g (w the
// calling warp, g = lane / 4) after n_mu scaled (mus), nq - n_mu bf16x3 and
// ns - nq fp32 steps from x = alpha, k that entry of ks: the steps on the 1
// x 1 system k, as its products compute them. Each product of a pad entry
// has one nonzero term; its three passes (hi hi, hi lo, lo hi) run on the
// tensor cores here too, by mma.sync with entry g's operands in row g of A
// and column g of B at k = 0, so its sum is D[g][g] (lane 4 g + g / 2, d[g %
// 2]), which a shuffle hands to the four lanes of g.
__device__ __forceinline__ float rf_pad_diag(float x, float k, const float* mus, int n_mu, int nq,
                                             int ns) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const bool k0 = (lane & 3) == 0;  // the lanes holding k = 0 of row g of A, column g of B
  auto diag = [&](const float (&d)[4]) {
    return __shfl_sync(0xffffffffu, (g & 1) ? d[1] : d[0], 4 * g + g / 2);
  };
  for (int it = 0; it < ns; ++it) {
    const float mu = it < n_mu ? mus[it] : 1.f;
    float kx[4] = {0.f, 0.f, 0.f, 0.f}, xt[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t kh, kl, xh, xl, th, tl;
    if (it < nq) {  // bf16x3: T = 2 - mu K X, then X = mu X T
      split_pair(k, 0.f, kh, kl);
      split_pair(x, 0.f, xh, xl);
      const uint32_t akh[4] = {k0 ? kh : 0u, 0u, 0u, 0u}, akl[4] = {k0 ? kl : 0u, 0u, 0u, 0u};
      mma_bf16(kx, akh, k0 ? xh : 0u, 0u);
      mma_bf16(kx, akh, k0 ? xl : 0u, 0u);
      mma_bf16(kx, akl, k0 ? xh : 0u, 0u);
      split_pair(rf_t(2.f, mu, diag(kx)), 0.f, th, tl);
      const uint32_t axh[4] = {k0 ? xh : 0u, 0u, 0u, 0u}, axl[4] = {k0 ? xl : 0u, 0u, 0u, 0u};
      mma_bf16(xt, axh, k0 ? th : 0u, 0u);
      mma_bf16(xt, axh, k0 ? tl : 0u, 0u);
      mma_bf16(xt, axl, k0 ? th : 0u, 0u);
      x = mu * diag(xt);
    } else {  // 3xTF32 into a fresh accumulator, which one add takes into the total
      split_tf32(k, kh, kl);
      split_tf32(x, xh, xl);
      const uint32_t akh[4] = {k0 ? kh : 0u, 0u, 0u, 0u}, akl[4] = {k0 ? kl : 0u, 0u, 0u, 0u};
      mma_tf32(kx, akh, k0 ? xh : 0u, 0u);
      mma_tf32(kx, akh, k0 ? xl : 0u, 0u);
      mma_tf32(kx, akl, k0 ? xh : 0u, 0u);
      split_tf32(rf_t(2.f, mu, 0.f + diag(kx)), th, tl);
      const uint32_t axh[4] = {k0 ? xh : 0u, 0u, 0u, 0u}, axl[4] = {k0 ? xl : 0u, 0u, 0u, 0u};
      mma_tf32(xt, axh, k0 ? th : 0u, 0u);
      mma_tf32(xt, axh, k0 ? tl : 0u, 0u);
      mma_tf32(xt, axl, k0 ? th : 0u, 0u);
      x = mu * (0.f + diag(xt));
    }
  }
  return x;
}

// The 256 tile's pad of a system the 192 instance (kPad) solves: rows and
// columns from 192 on, diagonal in hp (the identity, as the callers pad),
// so the 4-CTA instance's steps keep zeros off its diagonal and take each
// diagonal entry through the NS steps alone. Every warp of every CTA
// follows eight of them (rf_pad_diag) from alpha and pad (the pad's ks
// diagonal, rf_build) into xp (kLd - kN floats of shared memory); the CTA
// stores into out (the system's inv) zeros in its rows' pad columns and its
// share of the pad rows. a: the launch's schedule, mus its table in shared
// memory.
template <int kN>
__device__ __forceinline__ void rf_pad(float alpha, const RfArgs& a, const float* mus,
                                       const float* pad, float* xp, float* __restrict__ out,
                                       int q) {
  using S = RefineShape<kN>;
  constexpr int kW = (S::kLd - kN) / 4;  // float4 of a row's pad columns
  const int tid = threadIdx.x, i = 8 * (tid >> 5) + ((tid & 31) >> 2);
  static_assert(8 * RF_THREADS / 32 == S::kLd - kN, "eight pad entries a warp");
  const float x = rf_pad_diag(alpha, pad[i], mus, a.n_scaled, a.n_scaled + a.n_quad,
                              a.n_scaled + a.n_quad + a.n_hi);
  if ((tid & 3) == 0) xp[i] = x;
  for (int e = tid; e < S::kRows * kW; e += RF_THREADS)
    *reinterpret_cast<float4*>(out + (S::kRows * q + e / kW) * S::kLd + kN + 4 * (e % kW)) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // xp complete
  for (int e = tid + RF_THREADS * q; e < (S::kLd - kN) * S::kLd / 4; e += RF_THREADS * S::kCtas) {
    const int r = kN + e / (S::kLd / 4), c = 4 * (e % (S::kLd / 4)), dr = r - c;
    const float v = xp[r - kN];
    *reinterpret_cast<float4*>(out + r * S::kLd + c) = make_float4(
        dr == 0 ? v : 0.f, dr == 1 ? v : 0.f, dr == 2 ? v : 0.f, dr == 3 ? v : 0.f);
  }
}

// The system whose rank among the flagged systems of `tripped` (b flags) is
// `target`, or b if there are fewer: a block-wide scan of 256 flags at a
// time from `pos`, `rank` being the flagged systems before pos; both move
// past the system found. Every thread of the CTA must call it, with the
// same arguments; it returns the same in each. walk: 9 ints of scratch.
__device__ __forceinline__ int rf_flagged(const int* __restrict__ tripped, int b, int target,
                                          int& pos, int& rank, int* walk) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  while (pos < b) {
    const int p = pos + tid;
    const int f = p < b && tripped[p] != 0 ? 1 : 0;
    int incl = f;  // flags of this warp up to this thread's
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) walk[w] = incl;
    if (tid == 0) walk[8] = b;
    __syncthreads();  // the warps' counts stored
    int before = rank, total = rank;
#pragma unroll
    for (int v = 0; v < RF_THREADS / 32; ++v) {
      before += v < w ? walk[v] : 0;
      total += walk[v];
    }
    if (f && before + incl - 1 == target) walk[8] = p;
    __syncthreads();  // the system found, if any, stored
    const int found = walk[8];
    __syncthreads();  // every read of walk done
    if (found < b) {
      pos = found + 1;
      rank = target + 1;
      return found;
    }
    pos += RF_THREADS;
    rank = total;
  }
  return b;
}

// Dynamic shared memory of instance (kN, kMode): K6's three tiles and ring,
// for the other modes their scratch, for K2 its d (and at 192 the pad's ks
// diagonal and its result).
template <int kN, int kMode>
constexpr size_t rf_smem_bytes() {
  using S = RefineShape<kN>;
  return S::kSmemBytes + (kMode == RF_REFINE ? 0 : RF_SCRATCH * sizeof(float)) +
         (kMode == RF_BUILD ? (S::kPad ? 3 * S::kLd - 2 * kN : kN) * sizeof(float) : 0);
}

// a.ks, a.init (b, kN, kN) -> a.inv (b, kN, kN). RF_REFINE: n_quad bf16x3
// and n_hi fp32 quadratic steps from init. RF_WARM: the guard, then below it
// the warm steps from init (n_quad as the TPU kernel's n_wquad), else
// tripped[s] = 1 and nothing stored (tripped[s] = 0 for a warm system).
// RF_PLAIN: n_hi fp32 steps from I / ||K||_inf (init not read). RF_SCALED:
// n_scaled steps scaled by a.mu, n_quad bf16x3 and n_hi fp32 steps from I /
// ||K||_inf, on every system or, with a.tripped, on the flagged ones alone
// (nothing stored for the others). RF_BUILD: RF_SCALED's schedule on ks
// built from hp = a.ks and a.g9, d_row stored. Grid: kCtas CTAs (one
// cluster at 256) for each system the card runs at once; unit u walks
// systems u, u + units, ... (masked: the flagged systems of those ranks).
template <int kN, int kMode>
__global__ void __launch_bounds__(RF_THREADS, 1) ns_refine_kernel(const RfArgs a) {
  using S = RefineShape<kN>;
  constexpr bool kCold = kMode == RF_PLAIN || kMode == RF_SCALED || kMode == RF_BUILD;
  static_assert(!S::kPad || kMode == RF_BUILD, "the 192 instance is K2's");
  extern __shared__ __align__(128) float smem[];
  float* K = smem;
  float* X = K + S::kTile;
  float* T = X + S::kTile;
  float* ring = T + S::kTile;
  float* scr = ring + 2 * S::kSlot;  // every mode but RF_REFINE
  float* d = scr + RF_SCRATCH;      // RF_BUILD only
  [[maybe_unused]] float* pad = d + S::kLd;  // kPad only: the pad's ks diagonal, then its inverse's
  int q = 0;
  if constexpr (S::kCtas > 1) q = static_cast<int>(cg::this_cluster().block_rank());
  const int unit = blockIdx.x / S::kCtas, units = gridDim.x / S::kCtas, b = a.b;
  const size_t sys_floats = static_cast<size_t>(S::kLd) * S::kLd;
  const size_t rows = static_cast<size_t>(S::kRows) * S::kLd * q;  // the CTA's first row
  const bool masked = kMode == RF_SCALED && a.tripped != nullptr;
  int* walk = reinterpret_cast<int*>(scr + RF_WALK);
  int pos = 0, rank = 0, target = unit;
  int sys = masked ? rf_flagged(a.tripped, b, target, pos, rank, walk) : unit;
  if (sys >= b) return;
  if constexpr (kMode == RF_SCALED || kMode == RF_BUILD) {
    if (threadIdx.x < NS_MAX_MUS) scr[RF_MU + threadIdx.x] = a.mu[threadIdx.x];
  }
  // K's tile and X for system s, once ks's (hp's) rows are complete in K:
  // K2's build and the cold start, or X from init's rows in T
  auto begin = [&](int s) {
    if constexpr (kMode == RF_BUILD) {
      rf_build<kN>(K, d, a.ks + s * sys_floats, a.g9 + static_cast<size_t>(s) * 9 * a.nblk,
                   a.nblk, a.d_row + static_cast<size_t>(s) * S::kLd, q, pad);
      __syncthreads();  // the CTA's rows of ks complete
    }
    if constexpr (kCold) {
      [[maybe_unused]] const float alpha = rf_cold_start<kN>(K, X, scr, q, pad);
      if constexpr (S::kPad)
        rf_pad<kN>(alpha, a, scr + RF_MU, pad, pad + (S::kLd - kN), a.inv + s * sys_floats, q);
    } else {
      rf_transpose<kN>(T, X);
    }
  };
  rf_copy_tile<kN, true>(K, a.ks + sys * sys_floats + rows);
  if constexpr (!kCold) rf_copy_tile<kN, false>(T, a.init + sys * sys_floats + rows);
  cp_async_wait_all();
  __syncthreads();  // ks's (hp's) and init's rows complete
  begin(sys);
  rf_sync<kN>();  // K and X complete in every CTA
  for (;;) {
    int next = sys + units;
    if (masked) {
      target += units;
      next = rf_flagged(a.tripped, b, target, pos, rank, walk);
    }
    const float* next_k = next < b ? a.ks + next * sys_floats + rows : nullptr;
    float* out = a.inv + sys * sys_floats;
    // steps [0, n_mu) scaled by mu, [n_mu, nq) bf16x3, [nq, ns) fp32; K7:
    // the first of max(n_quad, 1) bf16x3 steps is the guard's (X0 (2I - K
    // X0), as the TPU kernel reuses K X0)
    const int n_mu = kMode == RF_SCALED || kMode == RF_BUILD ? a.n_scaled : 0;
    const int nq = n_mu + (kMode == RF_WARM ? max(a.n_quad, 1) : a.n_quad), ns = nq + a.n_hi;
    bool warm = true;
    for (int it = 0; it < ns; ++it) {
      const bool last = it + 1 == ns;
      if (it < nq) {
        const float mu = it < n_mu ? scr[RF_MU + it] : 1.f;
        warm = rf_step<kN, true, kMode == RF_WARM>(K, X, T, ring, q, last ? next_k : nullptr,
                                                   last ? out : nullptr, mu, it == 0, a.guard,
                                                   scr);
        if (!warm) break;
      } else {
        rf_step<kN, false>(K, X, T, ring, q, last ? next_k : nullptr, last ? out : nullptr, 1.f);
      }
    }
    if constexpr (kMode == RF_WARM) {
      if (q == 0 && threadIdx.x == 0) a.tripped[sys] = warm ? 0 : 1;
      // a tripped system (K3's launch runs it) leaves K free for the next ks
      if (!warm && next_k != nullptr) rf_copy_tile<kN, true>(K, next_k);
    }
    if (ns == 0) {  // no step: the result is the start itself
      for (int f = threadIdx.x; f < S::kTile; f += RF_THREADS)
        out[rows + (S::kPad ? f / kN * S::kLd + f % kN : f)] = X[blk<kN>(f / kN, f % kN)];
      __syncthreads();
      if (next_k != nullptr) rf_copy_tile<kN, true>(K, next_k);
    }
    if (next < b) {
      if constexpr (kCold) {
        cp_async_wait_all();
        __syncthreads();  // the next K complete; every read of X done
      } else {
        if constexpr (S::kCtas > 1) cg::this_cluster().sync();  // the peers' reads of T are done
        rf_copy_tile<kN, false>(T, a.init + next * sys_floats + rows);
        cp_async_wait_all();
        __syncthreads();  // the next init's rows complete in T
      }
      begin(next);
    }
    cp_async_wait_all();
    rf_sync<kN>();  // the next K and X complete in every CTA
    if (next >= b) break;
    sys = next;
  }
}

// The launch configuration of instance (kN, kMode) for b systems: as many
// CTAs (3- and 4-CTA clusters at 192 and 256) as the card holds at once, at
// most b of them.
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
int launch_refine(const RfArgs& a, void* stream) {
  if (a.b == 0) return 0;
  if (a.n_scaled > NS_MAX_MUS) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = refine_config<kN, kMode>(a.b, static_cast<cudaStream_t>(stream), cfg, attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, ns_refine_kernel<kN, kMode>, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The arguments of a launch on ks (hp), init and inv; the rest 0 or null.
inline RfArgs rf_args(const float* ks, const float* init, float* inv, int b) {
  RfArgs a{};
  a.ks = ks;
  a.init = init;
  a.inv = inv;
  a.b = b;
  return a;
}

// The scaled schedule into a: mus (n_scaled of them), n_quad, n_hi.
inline void rf_schedule(RfArgs& a, const float* mus, int n_scaled, int n_quad, int n_hi) {
  for (int i = 0; i < n_scaled && i < NS_MAX_MUS; ++i) a.mu[i] = mus[i];
  a.n_scaled = n_scaled;
  a.n_quad = n_quad;
  a.n_hi = n_hi;
}

}  // namespace qct

// K3's kernel masked to the flagged systems at the 128 tile: ns_inverse.cu.
extern "C" int qct_ns_inverse_scaled_masked(const float* ks, float* inv, const int* tripped, int b,
                                            const float* mus, int n_scaled, int n_quad, int n_hi,
                                            void* stream);

// C entry points (loaded with ctypes). Each returns the first failed launch's
// cudaError_t (0 when every launch went); the caller checks bounds and types.
extern "C" int qct_ns_inverse_refine(const float* ks, const float* init, float* inv, int b,
                                     int n_quad, int n_hi, void* stream) {
  qct::RfArgs a = qct::rf_args(ks, init, inv, b);
  a.n_quad = n_quad;
  a.n_hi = n_hi;
  return qct::launch_refine<128, qct::RF_REFINE>(a, stream);
}

extern "C" int qct_ns_inverse_refine_256(const float* ks, const float* init, float* inv, int b,
                                         int n_quad, int n_hi, void* stream) {
  qct::RfArgs a = qct::rf_args(ks, init, inv, b);
  a.n_quad = n_quad;
  a.n_hi = n_hi;
  return qct::launch_refine<256, qct::RF_REFINE>(a, stream);
}

// K9 at the 128 tile: `iters` fp32 steps from I / ||K||_inf.
extern "C" int qct_ns_inverse_plain(const float* ks, float* inv, int b, int iters, void* stream) {
  qct::RfArgs a = qct::rf_args(ks, nullptr, inv, b);
  a.n_hi = iters;
  return qct::launch_refine<128, qct::RF_PLAIN>(a, stream);
}

// K3 at the 256 tile: ks (b, 256, 256) Jacobi-scaled, identity on the pad.
extern "C" int qct_ns_inverse_scaled_256(const float* ks, float* inv, int b, const float* mus,
                                         int n_scaled, int n_quad, int n_hi, void* stream) {
  qct::RfArgs a = qct::rf_args(ks, nullptr, inv, b);
  qct::rf_schedule(a, mus, n_scaled, n_quad, n_hi);
  return qct::launch_refine<256, qct::RF_SCALED>(a, stream);
}

// K3 at 256 on the systems of ks whose flag in tripped (b int32) is not 0,
// nothing stored for the others: the cold branch of qct_ns_inverse_warm_256.
extern "C" int qct_ns_inverse_scaled_masked_256(const float* ks, float* inv, const int* tripped,
                                                int b, const float* mus, int n_scaled,
                                                int n_quad, int n_hi, void* stream) {
  qct::RfArgs a = qct::rf_args(ks, nullptr, inv, b);
  a.tripped = const_cast<int*>(tripped);  // read only in RF_SCALED
  qct::rf_schedule(a, mus, n_scaled, n_quad, n_hi);
  return qct::launch_refine<256, qct::RF_SCALED>(a, stream);
}

// K2 at the 256 tile: hp (b, 256, 256), g9 (b, 9, nblk) -> inv (b, 256,
// 256), d_row (b, 256); no ks. The caller must give an hp that is diagonal
// from row and column 3 nblk on (the identity pad; nothing here checks it):
// systems of at most 192 variables run on the 3-CTA instance over the
// leading 192, which reads only that diagonal beyond them, the rest on
// 4-CTA clusters over all 256.
extern "C" int qct_ns_inverse_scaled_build_256(const float* hp, const float* g9, int nblk,
                                               float* inv, float* d_row, int b, const float* mus,
                                               int n_scaled, int n_quad, int n_hi,
                                               void* stream) {
  qct::RfArgs a = qct::rf_args(hp, nullptr, inv, b);
  a.g9 = g9;
  a.d_row = d_row;
  a.nblk = nblk;
  qct::rf_schedule(a, mus, n_scaled, n_quad, n_hi);
  if (3 * nblk <= 192) return qct::launch_refine<192, qct::RF_BUILD>(a, stream);
  return qct::launch_refine<256, qct::RF_BUILD>(a, stream);
}

// Units (CTAs at 128, 3- and 4-CTA clusters at 192 and 256) of instance
// (npad, mode) the card holds at once, the grid of a large batch; for the
// record in chip_smoke.py, the launches do not need it.
extern "C" int qct_ns_refine_units(int npad, int mode, int* units) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cudaErrorInvalidValue;
  const int many = 1 << 30;
  if (npad == 128 && mode == qct::RF_REFINE)
    err = qct::refine_config<128, qct::RF_REFINE>(many, nullptr, cfg, attr);
  if (npad == 128 && mode == qct::RF_WARM)
    err = qct::refine_config<128, qct::RF_WARM>(many, nullptr, cfg, attr);
  if (npad == 128 && mode == qct::RF_PLAIN)
    err = qct::refine_config<128, qct::RF_PLAIN>(many, nullptr, cfg, attr);
  if (npad == 256 && mode == qct::RF_REFINE)
    err = qct::refine_config<256, qct::RF_REFINE>(many, nullptr, cfg, attr);
  if (npad == 256 && mode == qct::RF_WARM)
    err = qct::refine_config<256, qct::RF_WARM>(many, nullptr, cfg, attr);
  if (npad == 256 && mode == qct::RF_SCALED)
    err = qct::refine_config<256, qct::RF_SCALED>(many, nullptr, cfg, attr);
  if (npad == 256 && mode == qct::RF_BUILD)
    err = qct::refine_config<256, qct::RF_BUILD>(many, nullptr, cfg, attr);
  if (npad == 192 && mode == qct::RF_BUILD)
    err = qct::refine_config<192, qct::RF_BUILD>(many, nullptr, cfg, attr);
  *units = err == cudaSuccess ? static_cast<int>(cfg.gridDim.x) / (npad == 128 ? 1 : npad / 64) : 0;
  return static_cast<int>(err);
}

// K7's first launch alone (npad 128 or 256): the guard and the warm branch,
// tripped (b int32) set per system. For timing the two launches apart.
extern "C" int qct_ns_warm_guarded(const float* ks, const float* init, float* inv, int* tripped,
                                   int b, int n_wquad, int n_whi, float guard, int npad,
                                   void* stream) {
  qct::RfArgs a = qct::rf_args(ks, init, inv, b);
  a.tripped = tripped;
  a.n_quad = n_wquad;
  a.n_hi = n_whi;
  a.guard = guard;
  if (npad == 128) return qct::launch_refine<128, qct::RF_WARM>(a, stream);
  if (npad == 256) return qct::launch_refine<256, qct::RF_WARM>(a, stream);
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
