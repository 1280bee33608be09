// Packed condensed-MPC formation (K1), one block per scenario, the Gram on
// the tensor cores.
//
// Replaces the TPU kernel quadruped_ctrl_tpu/ops/formation_pack.py:
// form_packed_pallas (_kernel). Per scenario s of pair p = s / pack, slot
// i = s % pack:
//   u_m   = bfam_s[m] @ smat                      (13, n_c), m = 0..2, fp32
//   bq    rows x*13+q: sqrt(mask_x) * sum_m phi_m(x - step(col)) u_m[q]
//   H_p[i*n_c:(i+1)*n_c, i*n_c:(i+1)*n_c] = 2 bq'bq (bf16x3) + 2 alpha I
//   g_p[i*n_c:(i+1)*n_c]                  = 2 bq' r (fp32)
// and zeros in the rest of the scenario's n_c rows of H_p: the packed H is
// block diagonal, so no pair-level Gram is needed and scenarios never meet.
//
// Design. bq (13h x n_c) never reaches device memory, as it stayed in VMEM
// on the TPU: it is built once, straight into bf16 hi and lo planes in shared
// memory (split_pair's round-to-nearest split), rows and columns padded to
// a multiple of 16, pads zeroed on every launch. A thread owns a column pair
// and a share of the 13 rows q of a step: it computes its u_m[q] from bfam_s
// and smat (each entry of u once, none kept) and walks the h steps, so the
// gradient 2 bq' r sums in fp32 while bq's fp32 value is in a register. The
// plane rows are ld = cols + 8 bf16 apart, an odd number of 16-byte groups,
// so the 8 rows an ldmatrix phase reads fall in 8 distinct bank groups
// (cols apart where the block's memory has no room for the pad, at the
// largest horizons: FpLayout). The Gram bq'bq is mma.sync m16n8k16 bf16 in
// three passes (hi*hi, hi*lo, lo*hi) into one fp32 accumulator, with both operands read
// from the same planes by ldmatrix.x4.trans: A = bq' (m = column, k = row)
// and B = bq (k = row, n = column); no transposed copy, no split per read.
// Warp tiles are 32 x 32 and only those on or above the diagonal are
// computed: a tile's mirror is written from its transpose. bq is block lower
// triangular in steps (bq[x*13+q, c] = 0 when step(c) > x), so a tile whose
// columns start at d0 >= c0 starts its k loop at the 16-row chunk holding
// row 13 step(d0): the chunks skipped hold exact zeros in B. Masked steps
// are zero rows too but depend on the data, so they are not skipped. A warp
// stages each 8 x 32 quarter of a finished tile (and of its transpose) in
// its own scratch and writes whole 128-byte row segments of H with 16-byte
// stores; the zero blocks of a pair are written first, while the operands
// load. Shared memory: the planes, the warps' scratch and the small
// operands (qct_form_packed_smem_bytes; 50,104 bytes at h=10, four blocks
// an SM; 180,944 at h=16 with 192 columns, one).
//
// What bounds it, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section
// 6; probes/k1_times.py --phases times copies with a part cut out): no
// longer H's writes, its bytes bound, which a plain memset of H does in
// 0.039 ms at h=10 (batch 4096, 118 MB) and 0.096 ms at h=16, max_stance 4
// (batch 2048, 302 MB), against 0.104 and 0.290 ms for the kernel. The
// build (the loads, u, bq's expansion and split, the gradient) alone takes
// 0.071 and 0.139 ms: a chain of dependent steps with only 4 and 2 warps a
// scheduler to hide it. The Gram (~0.02 and ~0.09 ms) and the stores follow
// it in series within a block, and at h=16 the planes leave room for one
// block an SM, so nothing overlaps them. The fmaf Gram on the CUDA cores that
// this design replaced took 1.51 and 10.7 ms.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace qct {

constexpr int FP_MAX_NPAIR = 256;  // the largest packed system (the TPU kernel's 256 tile)
constexpr int FP_SS = 40;          // row stride of a warp's 8 x 32 fp32 scratch (8 mod 32 banks)
constexpr int64_t FP_SMEM_MAX = 227 * 1024;  // shared memory one H100 block may use

// Warps of a block: 4 for n_c <= 128, 8 above.
__host__ __device__ constexpr int fp_warps(bool big) { return big ? 8 : 4; }

// The 16-row chunk holding the first row that is not zero in columns 32 j
// on: row 13 step(32 j), step(col) = col / (3 ms). The kernel's Gram and
// qct_form_packed_mma_count both start tile column j there.
__host__ __device__ constexpr int fp_first_chunk(int j, int ms) {
  return 13 * ((32 * j) / (3 * ms)) / 16;
}

// The shared memory of one scenario's block, in bytes from its start. The
// plane rows are ld = cols + 8 bf16 apart where that fits in FP_SMEM_MAX,
// else cols apart (h >= 35 at max_stance 1, h = 25 at 2: 2-4 ldmatrix
// wavefronts a matrix there). When cols is not a multiple of 32, the last
// 32-column tile reads 16 columns past cols: the stride's pad, the next
// row's start and, after the lo plane, a 32-byte tail, all zeroed or built,
// whose products land in columns of H that are not stored.
struct FpLayout {
  int n_c, rows, rows_pad, cols, ld, warps, rg;
  int64_t lo, scratch, part, bfam, r, mask, total;
  __host__ __device__ FpLayout(int h, int ms)
      : n_c(3 * ms * h), rows(13 * h), rows_pad((13 * h + 15) / 16 * 16),
        cols((3 * ms * h + 15) / 16 * 16), warps(fp_warps(3 * ms * h > 128)),
        rg(32 * warps / (cols / 2)) {
    place(h, cols + 8);
    if (total > FP_SMEM_MAX) place(h, cols);
  }
  __host__ __device__ void place(int h, int row_ld) {
    ld = row_ld;
    lo = int64_t(2) * rows_pad * ld;                // bf16 hi plane, then lo
    scratch = 2 * lo + (cols % 32 ? 32 : 0);        // then the tail; warps x 8 x FP_SS floats
    part = scratch + int64_t(4) * warps * 8 * FP_SS;  // gradient partial sums, rg x cols
    bfam = part + int64_t(4) * rg * cols;           // bfam_s (3, 13, 12)
    r = bfam + 4 * 468;                             // r, rows_pad (zero past 13h)
    mask = r + int64_t(4) * rows_pad;               // sqrt(step mask), h
    total = mask + int64_t(4) * h;
  }
  __host__ __device__ int tile_cols() const { return (cols + 31) / 32; }
};

// acc += bq'[c0:c0+32, chunk kc] bq[chunk kc, d0:d0+32] in bf16x3 for the
// warp's 32 x 32 tile: A and B fragments by ldmatrix.x4.trans from the hi and
// lo planes (smem addresses hi, lo; rows ld bf16 apart), then 2 x 4 fragments
// x 3 passes of mma.sync.
__device__ __forceinline__ void fp_gram_chunk(uint32_t hi, uint32_t lo, int ld, int kc, int c0,
                                              int d0, float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31;
  // A (m = column c, k = row): matrices 0..3 are (k 0-7, m 0-7), (k 0-7,
  // m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15): a0..a3.
  const uint32_t a_off = 2u * ((16 * kc + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
                               (((lane >> 3) & 1) << 3));
  // B (k = row, n = column d): (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n
  // 8-15), (k 8-15, n 8-15): b0, b1 of two neighbouring 8-column tiles.
  const uint32_t b_off = 2u * ((16 * kc + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + d0 +
                               ((lane >> 4) << 3));
  uint32_t ah[2][4], al[2][4], bh[2][4], bl[2][4];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    ldsm_x4_trans(hi + a_off + 32 * x, ah[x]);   // 16 columns on: 32 bytes
    ldsm_x4_trans(lo + a_off + 32 * x, al[x]);
    ldsm_x4_trans(hi + b_off + 32 * x, bh[x]);
    ldsm_x4_trans(lo + b_off + 32 * x, bl[x]);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int np = nt >> 1, e = 2 * (nt & 1);
      mma_bf16(acc[mt][nt], ah[mt], bh[np][e], bh[np][e + 1]);
      mma_bf16(acc[mt][nt], ah[mt], bl[np][e], bl[np][e + 1]);
      mma_bf16(acc[mt][nt], al[mt], bh[np][e], bh[np][e + 1]);
    }
  }
}

// Rows r0..r0+7 (of the scenario's n_c) and columns col0..col0+31 of its
// block of H from the warp's 8 x 32 scratch st: 16-byte stores when n_c is a
// multiple of 4 (vec), else one float a lane.
__device__ __forceinline__ void fp_store_rows(const float* st, float* __restrict__ hrows,
                                              int n_pair, int lo_col, int n_c, int r0, int col0,
                                              bool vec) {
  const int lane = threadIdx.x & 31;
  if (vec) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int lr = 4 * it + (lane >> 3), c4 = 4 * (lane & 7);
      const int r = r0 + lr, c = col0 + c4;
      if (r < n_c && c < n_c)
        *reinterpret_cast<float4*>(hrows + static_cast<size_t>(r) * n_pair + lo_col + c) =
            *reinterpret_cast<const float4*>(st + lr * FP_SS + c4);
    }
  } else {
    for (int lr = 0; lr < 8; ++lr) {
      const int r = r0 + lr, c = col0 + lane;
      if (r < n_c && c < n_c) hrows[static_cast<size_t>(r) * n_pair + lo_col + c] = st[lr * FP_SS + lane];
    }
  }
}

// A finished tile (rows c0.., columns d0..) into H as 2 acc + 2 alpha I,
// through the warp's scratch a quarter of 8 rows at a time; above the
// diagonal (c0 < d0) its transpose too, as rows d0.. and columns c0...
__device__ __forceinline__ void fp_store_tile(const float (&acc)[2][4][4], float* st,
                                              float* __restrict__ hrows, int n_pair, int lo_col,
                                              int n_c, int c0, int d0, float alpha, bool vec) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = c0 + 16 * mt + 8 * hh + g;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int d = d0 + 8 * nt + 2 * t;
        float2 v;
        v.x = 2.f * acc[mt][nt][2 * hh] + (c == d ? 2.f * alpha : 0.f);
        v.y = 2.f * acc[mt][nt][2 * hh + 1] + (c == d + 1 ? 2.f * alpha : 0.f);
        *reinterpret_cast<float2*>(st + g * FP_SS + 8 * nt + 2 * t) = v;
      }
      __syncwarp();
      fp_store_rows(st, hrows, n_pair, lo_col, n_c, c0 + 16 * mt + 8 * hh, d0, vec);
      __syncwarp();
    }
  }
  if (c0 == d0) return;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {  // rows d0 + 8 nt + (2t + e), columns c0 + (16 mt + 8 hh + g)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          st[(2 * t + e) * FP_SS + 16 * mt + 8 * hh + g] = 2.f * acc[mt][nt][2 * hh + e];
    __syncwarp();
    fp_store_rows(st, hrows, n_pair, lo_col, n_c, d0 + 8 * nt, c0, vec);
    __syncwarp();
  }
}

// kBig is false for n_c <= 128 (4 warps, up to 4 blocks an SM at h=10) and
// true above (8 warps; the planes leave room for one block an SM).
template <bool kBig>
__global__ void __launch_bounds__(32 * fp_warps(kBig), kBig ? 1 : 4)
form_packed_kernel(const float* __restrict__ bfam, const float* __restrict__ smat,
                   const float* __restrict__ r, const float* __restrict__ smask,
                   float* __restrict__ hess, float* __restrict__ grad, int h, int ms,
                   int pack, float alpha) {
  constexpr int kWarps = fp_warps(kBig), kThreads = 32 * kWarps;
  const FpLayout L(h, ms);
  const int n_c = L.n_c, n_pair = pack * n_c, rows = L.rows, ld = L.ld;
  const int s = blockIdx.x;
  const int pair = s / pack, slot = s % pack, lo_col = slot * n_c;
  const int tid = threadIdx.x, warp = tid >> 5;
  const bool vec = (n_c & 3) == 0;

  extern __shared__ __align__(16) float fp_sm[];
  char* base = reinterpret_cast<char*>(fp_sm);
  uint32_t* qhi = reinterpret_cast<uint32_t*>(base);           // bf16x2 words, ld / 2 a row
  uint32_t* qlo = reinterpret_cast<uint32_t*>(base + L.lo);
  float* scratch = reinterpret_cast<float*>(base + L.scratch);
  float* sp = reinterpret_cast<float*>(base + L.part);
  float* sb = reinterpret_cast<float*>(base + L.bfam);
  float* sr = reinterpret_cast<float*>(base + L.r);
  float* sk = reinterpret_cast<float*>(base + L.mask);

  // Every global load first, into registers, so that their latencies
  // overlap: bfam_s as float4s (468 floats, 16-byte aligned a scenario), the
  // step mask (h < 128), and the two smat columns of a thread of the build
  // below (zero past n_c).
  const int npc = L.cols / 2;
  const int p = tid % npc, rg = tid / npc, c = 2 * p;
  const bool builds = rg < L.rg;
  float s0[12], s1[12];
  const float* sms = smat + static_cast<size_t>(s) * 12 * n_c;
#pragma unroll
  for (int f = 0; f < 12; ++f) {
    s0[f] = builds && c < n_c ? __ldg(sms + f * n_c + c) : 0.f;
    s1[f] = builds && c + 1 < n_c ? __ldg(sms + f * n_c + c + 1) : 0.f;
  }
  const float4 bf = tid < 117 ? __ldg(reinterpret_cast<const float4*>(bfam) + s * 117 + tid)
                              : float4{0.f, 0.f, 0.f, 0.f};
  const float kv = tid < h ? smask[static_cast<size_t>(s) * h + tid] : 0.f;

  // the scenario's rows of H_p outside its own block are zero (pack > 1)
  float* hrows = hess + static_cast<size_t>(pair) * n_pair * n_pair +
                 static_cast<size_t>(lo_col) * n_pair;
  const int zc = n_pair - n_c;
  if (vec) {
    const float4 z = {0.f, 0.f, 0.f, 0.f};
    for (int idx = tid; idx < n_c * (zc / 4); idx += kThreads) {
      const int row = idx / (zc / 4), j = 4 * (idx % (zc / 4));
      *reinterpret_cast<float4*>(hrows + static_cast<size_t>(row) * n_pair + j +
                                 (j >= lo_col ? n_c : 0)) = z;
    }
  } else {
    for (int idx = tid; idx < n_c * zc; idx += kThreads) {
      const int row = idx / zc, j = idx % zc;
      hrows[static_cast<size_t>(row) * n_pair + j + (j >= lo_col ? n_c : 0)] = 0.f;
    }
  }

  for (int i0 = 0; i0 < L.rows_pad; i0 += 2 * kThreads) {  // r, two loads in flight
    const int i = i0 + tid, j = i + kThreads;
    const float a = i < rows ? r[static_cast<size_t>(s) * rows + i] : 0.f;
    const float b = j < rows ? r[static_cast<size_t>(s) * rows + j] : 0.f;
    if (i < L.rows_pad) sr[i] = a;
    if (j < L.rows_pad) sr[j] = b;
  }
  if (tid < 117) reinterpret_cast<float4*>(sb)[tid] = bf;
  if (tid < h) sk[tid] = kv;
  const int half = ld / 2;  // plane words a row
  for (int idx = tid; idx < (L.rows_pad - rows) * half; idx += kThreads) {
    qhi[rows * half + idx] = 0u;
    qlo[rows * half + idx] = 0u;
  }
  if (L.cols % 32) {  // what the last tile reads past cols (FpLayout)
    const int padw = half - L.cols / 2;
    for (int idx = tid; idx < rows * padw; idx += kThreads) {
      const int w = (idx / padw) * half + L.cols / 2 + idx % padw;
      qhi[w] = 0u;
      qlo[w] = 0u;
    }
    if (tid < 8) qlo[L.rows_pad * half + tid] = 0u;
  }
  __syncthreads();

  // bq into the planes and 2 bq' r: thread (p, rg) owns columns 2p, 2p+1
  // (s0, s1) and rows q = rg, rg + L.rg, ... of every step x.
  // Toeplitz expansion: phi_0 = tri, phi_1 = k tri, phi_2 = k(k-1)/2 tri with
  // k = x - step(col), step(col) = col / (3 ms) for the (step, slot, xyz) order
  if (builds) {
    const float st0 = static_cast<float>(c / (3 * ms)), st1 = static_cast<float>((c + 1) / (3 * ms));
    float g0 = 0.f, g1 = 0.f;
    for (int q = rg; q < 13; q += L.rg) {
      float u0[3], u1[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int f = 0; f < 12; ++f) {
          const float w = sb[(m * 13 + q) * 12 + f];
          a0 = fmaf(w, s0[f], a0);
          a1 = fmaf(w, s1[f], a1);
        }
        u0[m] = a0;
        u1[m] = a1;
      }
#pragma unroll 4
      for (int x = 0; x < h; ++x) {  // independent steps: 4 in flight
        const int row = 13 * x + q;
        const float k0 = static_cast<float>(x) - st0, k1 = static_cast<float>(x) - st1;
        const float t0 = k0 >= 0.f ? 1.f : 0.f, t1 = k1 >= 0.f ? 1.f : 0.f;
        const float v0 = sk[x] * (t0 * u0[0] + (k0 * t0) * u0[1] + (0.5f * k0 * (k0 - 1.f) * t0) * u0[2]);
        const float v1 = sk[x] * (t1 * u1[0] + (k1 * t1) * u1[1] + (0.5f * k1 * (k1 - 1.f) * t1) * u1[2]);
        uint32_t whi, wlo;
        split_pair(v0, v1, whi, wlo);
        qhi[row * half + p] = whi;
        qlo[row * half + p] = wlo;
        g0 = fmaf(sr[row], v0, g0);
        g1 = fmaf(sr[row], v1, g1);
      }
    }
    sp[rg * L.cols + c] = g0;
    sp[rg * L.cols + c + 1] = g1;
  }
  __syncthreads();

  for (int col = tid; col < n_c; col += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < L.rg; ++k) acc += sp[k * L.cols + col];
    grad[static_cast<size_t>(pair) * n_pair + lo_col + col] = 2.f * acc;
  }

  // The Gram's warp tiles (i, j), i <= j, in order of j (the k loop shortens
  // as j grows), dealt to the warps back and forth: 0..W-1, W-1..0, ...
  const uint32_t hi_s = smem_addr(qhi), lo_s = smem_addr(qlo);
  const int chunks = L.rows_pad / 16;
  float* st = scratch + warp * 8 * FP_SS;
  int tau = 0;
  for (int j = 0; j < L.tile_cols(); ++j) {
    const int kc0 = fp_first_chunk(j, ms);
    for (int i = 0; i <= j; ++i, ++tau) {
      const int pos = tau % (2 * kWarps);
      if ((pos < kWarps ? pos : 2 * kWarps - 1 - pos) != warp) continue;
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
      for (int kc = kc0; kc < chunks; ++kc) fp_gram_chunk(hi_s, lo_s, ld, kc, 32 * i, 32 * j, acc);
      fp_store_tile(acc, st, hrows, n_pair, lo_col, n_c, 32 * i, 32 * j, alpha, vec);
    }
  }
}

}  // namespace qct

// Shared memory one scenario needs, in bytes.
extern "C" int64_t qct_form_packed_smem_bytes(int h, int ms) { return qct::FpLayout(h, ms).total; }

// mma.sync m16n8k16 one scenario's Gram runs, over the three bf16 passes:
// per 16-row chunk a 32 x 32 tile takes 2 x 4 fragments; tile column j has
// j + 1 tiles on or above the diagonal, each from fp_first_chunk(j, ms).
extern "C" int64_t qct_form_packed_mma_count(int h, int ms) {
  const qct::FpLayout L(h, ms);
  int64_t tile_chunks = 0;
  for (int j = 0; j < L.tile_cols(); ++j)
    tile_chunks += int64_t(j + 1) * (L.rows_pad / 16 - qct::fp_first_chunk(j, ms));
  return tile_chunks * 2 * 4 * 3;
}

// bfam (B,3,13,12), smat (B,12,n_c), r (B,13h), smask (B,h) ->
// hess (B/pack, n_pair, n_pair), grad (B/pack, n_pair). Returns the launch's
// cudaError_t; the caller checks shapes, types, n_pair <= 256 and the shared
// memory one scenario needs.
extern "C" int qct_form_packed(const float* bfam, const float* smat, const float* r,
                               const float* smask, float* hess, float* grad, int b, int h,
                               int ms, int pack, float alpha, void* stream) {
  if (pack * 3 * ms * h > qct::FP_MAX_NPAIR) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = qct_form_packed_smem_bytes(h, ms);
  const bool big = 3 * ms * h > 128;
  auto kernel = big ? qct::form_packed_kernel<true> : qct::form_packed_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  kernel<<<b, 32 * qct::fp_warps(big), static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(bfam, smat, r, smask, hess, grad, h, ms, pack,
                                                alpha);
  return static_cast<int>(cudaGetLastError());
}
