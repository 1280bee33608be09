// Packed condensed-MPC formation, one block per scenario.
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
// What bounds it on an H100: at the flagship shape (h=10, ms=2, pack=2) the
// writes of the packed H (n_pair^2 floats per pair, 118 MB at batch 4096)
// against ~1.4 M FMAs per scenario for the Gram; bq (13h x n_c) stays in
// shared memory and never reaches device memory, as it stayed in VMEM on the
// TPU. Rows and columns of the Gram are spread over a 16 x 16 thread grid
// with an 8 x 8 register grid each, which covers 128 x 128 outputs; above
// n_c = 128 (h=16, ms=4: n_c = 192, 201,680 bytes of shared memory) the Gram
// loops over output tiles of at most 128 x 128. Packed systems of up to 256
// variables (the TPU kernel's 256 tile) are taken.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace qct {

constexpr int FP_THREADS = 256;
constexpr int FP_TILE = 128;     // Gram output tile the 16 x 16 x 8 register grid covers
constexpr int FP_MAX_NPAIR = 256;  // the largest packed system (the TPU kernel's 256 tile)

__device__ __forceinline__ void fp_split(float a, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(a));
  lo = __bfloat162float(__float2bfloat16_rn(a - hi));
}

// One output tile of the Gram 2 bq'bq (+ 2 alpha I on the diagonal) in
// bf16x3: rows c0 + ty + 16a (a < ntc) and columns d0 + tx + 16b (b < ntd)
// of the scenario's n_c x n_c block, written at row offset 0 and column
// offset lo_col of hrows (row stride n_pair).
__device__ __forceinline__ void gram_tile(const float* sq, int rows, int n_c, int c0, int d0,
                                          int ntc, int ntd, float* __restrict__ hrows,
                                          int n_pair, int lo_col, float alpha) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  for (int row = 0; row < rows; ++row) {
    const float* q = sq + row * n_c;
    float ch[8], cl[8], dh[8], dl[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int c = c0 + ty + 16 * a;
      fp_split((a < ntc && c < n_c) ? q[c] : 0.f, ch[a], cl[a]);
      const int d = d0 + tx + 16 * a;
      fp_split((a < ntd && d < n_c) ? q[d] : 0.f, dh[a], dl[a]);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      if (a >= ntc) break;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (b >= ntd) break;
        acc[a][b] = fmaf(ch[a], dh[b], acc[a][b]);
        acc[a][b] = fmaf(ch[a], dl[b], acc[a][b]);
        acc[a][b] = fmaf(cl[a], dh[b], acc[a][b]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int c = c0 + ty + 16 * a, d = d0 + tx + 16 * b;
      if (a < ntc && b < ntd && c < n_c && d < n_c) {
        hrows[static_cast<size_t>(c) * n_pair + lo_col + d] =
            2.f * acc[a][b] + (c == d ? 2.f * alpha : 0.f);
      }
    }
  }
}

// kTiled is false for n_c <= 128 (one Gram tile, 117 registers at h=10,
// two blocks per SM) and true above (the tile loop; one block per SM by its
// shared memory anyway): one instantiation each, so that the loop does not
// raise the single-tile kernel's register count.
template <bool kTiled>
__global__ void __launch_bounds__(FP_THREADS)
form_packed_kernel(const float* __restrict__ bfam, const float* __restrict__ smat,
                   const float* __restrict__ r, const float* __restrict__ smask,
                   float* __restrict__ hess, float* __restrict__ grad, int h, int ms,
                   int pack, float alpha) {
  const int n_c = 3 * ms * h;
  const int n_pair = pack * n_c;
  const int rows = 13 * h;
  const int s = blockIdx.x;
  const int pair = s / pack, slot = s % pack;
  const int tid = threadIdx.x;

  extern __shared__ float sm[];
  float* sb = sm;                  // bfam_s (3, 13, 12)
  float* ss = sb + 3 * 13 * 12;    // smat (12, n_c)
  float* su = ss + 12 * n_c;       // u (3, 13, n_c)
  float* sq = su + 39 * n_c;       // bq (rows, n_c)
  float* sr = sq + rows * n_c;     // r (rows)
  float* sk = sr + rows;           // sqrt(step mask) (h)

  for (int i = tid; i < 3 * 13 * 12; i += FP_THREADS) sb[i] = bfam[static_cast<size_t>(s) * 468 + i];
  for (int i = tid; i < 12 * n_c; i += FP_THREADS) ss[i] = smat[static_cast<size_t>(s) * 12 * n_c + i];
  for (int i = tid; i < rows; i += FP_THREADS) sr[i] = r[static_cast<size_t>(s) * rows + i];
  for (int i = tid; i < h; i += FP_THREADS) sk[i] = smask[static_cast<size_t>(s) * h + i];
  __syncthreads();

  for (int idx = tid; idx < 39 * n_c; idx += FP_THREADS) {
    const int mq = idx / n_c, c = idx % n_c;
    float acc = 0.f;
#pragma unroll
    for (int f = 0; f < 12; ++f) acc = fmaf(sb[mq * 12 + f], ss[f * n_c + c], acc);
    su[idx] = acc;
  }
  __syncthreads();

  // Toeplitz expansion: phi_0 = tri, phi_1 = k tri, phi_2 = k(k-1)/2 tri with
  // k = x - step(col), step(col) = col / (3 ms) for the (step, slot, xyz) order
  for (int idx = tid; idx < rows * n_c; idx += FP_THREADS) {
    const int row = idx / n_c, c = idx % n_c;
    const int x = row / 13, q = row % 13;
    const float k = static_cast<float>(x) - static_cast<float>(c / (3 * ms));
    const float tri = k >= 0.f ? 1.f : 0.f;
    const float v = tri * su[q * n_c + c] + (k * tri) * su[(13 + q) * n_c + c] +
                    (0.5f * k * (k - 1.f) * tri) * su[(26 + q) * n_c + c];
    sq[idx] = sk[x] * v;
  }
  __syncthreads();

  float* hrows = hess + static_cast<size_t>(pair) * n_pair * n_pair +
                 static_cast<size_t>(slot) * n_c * n_pair;
  for (int c = tid; c < n_c; c += FP_THREADS) {
    float acc = 0.f;
    for (int row = 0; row < rows; ++row) acc = fmaf(sr[row], sq[row * n_c + c], acc);
    grad[static_cast<size_t>(pair) * n_pair + slot * n_c + c] = 2.f * acc;
  }
  const int lo_col = slot * n_c, hi_col = lo_col + n_c;
  for (int idx = tid; idx < n_c * n_pair; idx += FP_THREADS) {
    const int j = idx % n_pair;
    if (j < lo_col || j >= hi_col) hrows[idx] = 0.f;
  }

  // Gram 2 bq'bq in bf16x3: one output tile when n_c <= 128, else tiles of
  // at most FP_TILE x FP_TILE (2 x 2 at n_c = 192)
  if (!kTiled) {
    const int nt = (n_c + 15) / 16;
    gram_tile(sq, rows, n_c, 0, 0, nt, nt, hrows, n_pair, lo_col, alpha);
  } else {
    for (int c0 = 0; c0 < n_c; c0 += FP_TILE) {
      for (int d0 = 0; d0 < n_c; d0 += FP_TILE) {
        gram_tile(sq, rows, n_c, c0, d0, (min(FP_TILE, n_c - c0) + 15) / 16,
                  (min(FP_TILE, n_c - d0) + 15) / 16, hrows, n_pair, lo_col, alpha);
      }
    }
  }
}

}  // namespace qct

// Shared memory one scenario needs, in bytes.
extern "C" int64_t qct_form_packed_smem_bytes(int h, int ms) {
  const int64_t n_c = 3 * ms * h, rows = 13 * h;
  return static_cast<int64_t>(sizeof(float)) * (468 + 12 * n_c + 39 * n_c + rows * n_c + rows + h);
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
  const bool tiled = 3 * ms * h > qct::FP_TILE;
  auto kernel = tiled ? qct::form_packed_kernel<true> : qct::form_packed_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  kernel<<<b, qct::FP_THREADS, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      bfam, smat, r, smask, hess, grad, h, ms, pack, alpha);
  return static_cast<int>(cudaGetLastError());
}
