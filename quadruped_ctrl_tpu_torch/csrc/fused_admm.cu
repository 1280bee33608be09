// The whole batched MPC QP solve in one launch, one block per system.
//
// fused_admm_kernel replaces the TPU kernel
//   quadruped_ctrl_tpu/ops/fused_admm.py: fused_admm_solve (_kernel)
//
// Per system: K = H + sigma I + A' diag(rho) A, Jacobi scale, the NS schedule
// (fa_ns_schedule below), unscale; n_iter over-relaxed ADMM iterations
// against that inverse; polish_rounds active-set rounds, each building,
// scaling and inverting its own penalty matrix kp = H + sigma I + A' diag(w) A
// and solving with two refinement passes against kp. The arithmetic is the
// TPU kernel's (and fused_admm_solve_reference's) with every matvec and the
// gram in fp32 FMAs and the NS products in bf16x3 as in K2.
//
// The NS products. K5 still runs the CUDA-core product that K2/K3 ran at the
// 128 tile before they moved to the tensor cores (ns_core.cuh): fa_mm_tile,
// fa_ns_step and fa_ns_schedule below, unchanged but for their names and the
// tile stride, kept here because only K5 runs them. Each bf16x3 product is
// 128^3 x 3 fp32 FMAs on the CUDA cores, operands split on every read, each
// thread an 8 x 8 grid of outputs. They need the 128 x 129 padded tiles
// below, which is also where K5 stages A. Moving K5 onto the tensor cores
// (with its own layout for A) is the next kernel PR (ROADMAP).
//
// Residency. The three 128 x 129 float tiles of the NS products (198,144 bytes)
// are the block's shared memory, with the vectors beside them. Their roles
// rotate: K (the matrix being inverted), the inverse, and scratch, which holds
// the constraint matrix A (256 x 128, shared by every system and hot in L2)
// staged from global memory whenever a tile is free:
//   build    A in X|T            -> K = H + sigma I + gram(rho), scaled in K
//   NS       fa_ns_schedule(K, X, T) -> X = inverse, unscaled in place
//   ADMM     A in K|T, inverse in X; every matvec reads shared memory
//   round    A in K|T -> b = -g + A'(w bound - y); kp built into X, scaled;
//            fa_ns_schedule(X, K, T) -> K = inverse, unscaled; kp rebuilt
//            unscaled into X with A staged through T half by half; the
//            refinement matvecs read K and X; A's first half is staged into
//            K again, so A is in K|T for Ax and for the next round.
// A is never assumed to have the pyramid's structure.
//
// Threads: 256, one per constraint row (M = 256), so z, y, l, u, rho, the
// active flags and the AL duals live in registers; an x-space matvec runs two
// threads per output row, each summing half the columns.
//
// What bounds it on an H100: the five factorizations (12 NS steps each, three
// fp32 FMAs per bf16x3 term on the CUDA cores) are ~90% of the
// operations; the ADMM iterate is ~80K FMAs per iteration from shared memory
// behind four block barriers, bound by latency more than by FMA throughput at
// one block per SM.
#include <cuda_bf16.h>

#include <cstdint>

#include "ns_core.cuh"

namespace qct {

constexpr int FA_N = NS_N;        // padded variable count
constexpr int FA_M = 256;         // padded constraint-row count
constexpr int FA_LD = NS_N + 1;   // tile row stride: rows fall in distinct banks
constexpr int FA_TILE = NS_N * FA_LD;
constexpr float FLT_MAX_F = 3.402823466e38f;  // |v| <= it: v is finite
static_assert(NS_THREADS == FA_M, "one thread per constraint row");

struct FaParams {
  NsSchedule s;
  int n_iter;
  int polish_rounds;
  float sigma;
  float alpha;
  float w_act;
  float act_tol;
  float infty;
};

// Shared vectors beside the three tiles.
struct FaVecs {
  float d[FA_N];      // Jacobi scale of the matrix being inverted
  float xv[FA_N];     // x-space operand of a matvec
  float bv[FA_N];     // polish right-hand side
  float mv[FA_M];     // constraint-space operand of A'v
  float wv[FA_M];     // gram weights
  float part[FA_M];   // two partial sums per x-space output
  float red[NS_THREADS / 32];
};
constexpr size_t FA_SMEM_BYTES = 3 * FA_TILE * sizeof(float) + sizeof(FaVecs);

__device__ __forceinline__ void split_bf16(float a, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(a));
  lo = __bfloat162float(__float2bfloat16_rn(a - hi));
}

// acc = A @ B for the calling thread's 8 x 8 output grid; A and B are
// NS_N x NS_N tiles in shared memory with row stride FA_LD.
template <bool kBf16x3>
__device__ __forceinline__ void fa_mm_tile(const float* __restrict__ A,
                                           const float* __restrict__ B,
                                           float (&acc)[8][8]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 2
  for (int k = 0; k < NS_N; ++k) {
    float a[8], b[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) a[r] = A[(ty + 16 * r) * FA_LD + k];
#pragma unroll
    for (int c = 0; c < 8; ++c) b[c] = B[k * FA_LD + tx + 16 * c];
    if (kBf16x3) {
      float ah[8], al[8], bh[8], bl[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) split_bf16(a[r], ah[r], al[r]);
#pragma unroll
      for (int c = 0; c < 8; ++c) split_bf16(b[c], bh[c], bl[c]);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc[r][c] = fmaf(ah[r], bh[c], acc[r][c]);
          acc[r][c] = fmaf(ah[r], bl[c], acc[r][c]);
          acc[r][c] = fmaf(al[r], bh[c], acc[r][c]);
        }
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
}

// One NS step: T = 2I - mu K X, then X = mu X T. mu = 1 gives the quadratic
// step exactly (1.0f * v == v).
template <bool kBf16x3>
__device__ __forceinline__ void fa_ns_step(const float* K, float* X, float* T, float mu) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[8][8];
  fa_mm_tile<kBf16x3>(K, X, acc);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int i = ty + 16 * r, j = tx + 16 * c;
      T[i * FA_LD + j] = (i == j ? 2.f : 0.f) - mu * acc[r][c];
    }
  __syncthreads();
  fa_mm_tile<kBf16x3>(X, T, acc);
  __syncthreads();  // every read of X is done before it is overwritten
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) X[(ty + 16 * r) * FA_LD + tx + 16 * c] = mu * acc[r][c];
  __syncthreads();
}

// Runs the whole schedule on K (read only) into X; T is scratch. Every
// thread of the block must call it.
__device__ __forceinline__ void fa_ns_schedule(const float* K, float* X, float* T,
                                               const NsSchedule& s) {
  __shared__ float warp_max[NS_THREADS / 32];
  const int tid = threadIdx.x;
  // alpha = 1 / max_i sum_j |K_ij|: rows on the first NS_N threads
  float row = 0.f;
  if (tid < NS_N) {
    for (int j = 0; j < NS_N; ++j) row += fabsf(K[tid * FA_LD + j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) row = fmaxf(row, __shfl_xor_sync(0xffffffffu, row, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = row;
  __syncthreads();
  float mx = warp_max[0];
#pragma unroll
  for (int w = 1; w < NS_THREADS / 32; ++w) mx = fmaxf(mx, warp_max[w]);
  const float alpha = 1.f / mx;
  for (int idx = tid; idx < NS_N * NS_N; idx += NS_THREADS) {
    const int i = idx / NS_N, j = idx % NS_N;
    X[i * FA_LD + j] = (i == j) ? alpha : 0.f;
  }
  __syncthreads();
  for (int it = 0; it < s.n_scaled; ++it) fa_ns_step<true>(K, X, T, s.mu[it]);
  for (int it = 0; it < s.n_quad; ++it) fa_ns_step<true>(K, X, T, 1.f);
  for (int it = 0; it < s.n_hi; ++it) fa_ns_step<false>(K, X, T, 1.f);
}

// Rows [row0, row0 + 128) of A (M x N, row-major, global) into dst.
__device__ __forceinline__ void stage_rows(const float* __restrict__ a, int row0, float* dst) {
  const float* src = a + static_cast<size_t>(row0) * FA_N;
  for (int idx = threadIdx.x; idx < FA_N * FA_N; idx += NS_THREADS) {
    dst[(idx >> 7) * FA_LD + (idx & 127)] = __ldg(src + idx);
  }
}

// acc += sum over the 128 rows m of `a_half` (staged, row stride FA_LD) of
// (A[m, i] w[m]) A[m, j], for the thread's 8 x 8 output grid.
__device__ __forceinline__ void gram_acc(const float* a_half, const float* w,
                                         float (&acc)[8][8]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int m = 0; m < FA_N; ++m) {
    const float wm = w[m];
    float av[8], bv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) av[r] = a_half[m * FA_LD + ty + 16 * r] * wm;
#pragma unroll
    for (int c = 0; c < 8; ++c) bv[c] = a_half[m * FA_LD + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
}

// dst = (H + sigma I) + acc.
__device__ __forceinline__ void write_k(const float* __restrict__ hess, float sigma,
                                        const float (&acc)[8][8], float* dst) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int i = ty + 16 * r, j = tx + 16 * c;
      dst[i * FA_LD + j] = (hess[i * FA_N + j] + (i == j ? sigma : 0.f)) + acc[r][c];
    }
}

// d = rsqrt(max(diag K, 1e-30)), K <- K * d_j * d_i.
__device__ __forceinline__ void jacobi_scale(float* K, float* d) {
  if (threadIdx.x < FA_N) {
    d[threadIdx.x] = 1.f / sqrtf(fmaxf(K[threadIdx.x * FA_LD + threadIdx.x], 1e-30f));
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < FA_N * FA_N; idx += NS_THREADS) {
    const int i = idx >> 7, j = idx & 127;
    K[i * FA_LD + j] = K[i * FA_LD + j] * d[j] * d[i];
  }
  __syncthreads();
}

__device__ __forceinline__ void unscale(float* X, const float* d) {
  for (int idx = threadIdx.x; idx < FA_N * FA_N; idx += NS_THREADS) {
    const int i = idx >> 7, j = idx & 127;
    X[i * FA_LD + j] = X[i * FA_LD + j] * d[j] * d[i];
  }
  __syncthreads();
}

// (Mat v)_i for the symmetric N x N tile Mat: the thread's half of row i
// (i = tid & 127, columns [64h, 64h + 64), h = tid >> 7) into part[tid];
// returns part[i] + part[i + 128] on threads < 128. Every thread calls it.
__device__ __forceinline__ float x_matvec(const float* Mat, const float* v, float* part) {
  const int i = threadIdx.x & 127, j0 = (threadIdx.x >> 7) * 64;
  float s = 0.f;
#pragma unroll 8
  for (int j = j0; j < j0 + 64; ++j) s = fmaf(Mat[i * FA_LD + j], v[j], s);
  part[threadIdx.x] = s;
  __syncthreads();
  const float out = threadIdx.x < FA_N ? part[threadIdx.x] + part[threadIdx.x + FA_N] : 0.f;
  __syncthreads();
  return out;
}

// (A' v)_i with A's rows [0,128) in A0 and [128,256) in A1; as x_matvec.
__device__ __forceinline__ float at_matvec(const float* A0, const float* A1, const float* v,
                                           float* part) {
  const int i = threadIdx.x & 127, h = threadIdx.x >> 7;
  const float* Ah = h ? A1 : A0;
  const float* vh = v + h * FA_N;
  float s = 0.f;
#pragma unroll 8
  for (int m = 0; m < FA_N; ++m) s = fmaf(Ah[m * FA_LD + i], vh[m], s);
  part[threadIdx.x] = s;
  __syncthreads();
  const float out = threadIdx.x < FA_N ? part[threadIdx.x] + part[threadIdx.x + FA_N] : 0.f;
  __syncthreads();
  return out;
}

// (A x)_t for the calling thread's row t.
__device__ __forceinline__ float a_row(const float* A0, const float* A1, const float* x) {
  const int t = threadIdx.x;
  const float* row = t < FA_N ? A0 + t * FA_LD : A1 + (t - FA_N) * FA_LD;
  float s = 0.f;
#pragma unroll 8
  for (int i = 0; i < FA_N; ++i) s = fmaf(row[i], x[i], s);
  return s;
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < NS_THREADS / 32; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

// a (M, N) shared; hess (B, N, N); grad (B, N); l, u, rho (B, M) -> x (B, N).
__global__ void __launch_bounds__(NS_THREADS)
fused_admm_kernel(const float* __restrict__ a, const float* __restrict__ hess_all,
                  const float* __restrict__ grad_all, const float* __restrict__ l_all,
                  const float* __restrict__ u_all, const float* __restrict__ rho_all,
                  float* __restrict__ x_out, FaParams p) {
  extern __shared__ float smem[];
  float* K = smem;
  float* X = K + FA_TILE;
  float* T = X + FA_TILE;
  FaVecs& v = *reinterpret_cast<FaVecs*>(T + FA_TILE);
  const int t = threadIdx.x;
  const size_t sys = blockIdx.x;
  const float* hess = hess_all + sys * FA_N * FA_N;

  // per-row state of row t; x-space state of row t on threads < N
  const float l = l_all[sys * FA_M + t];
  const float u = u_all[sys * FA_M + t];
  const float rho = rho_all[sys * FA_M + t];
  const float inv_rho = 1.f / rho;
  const bool finite_u = u < p.infty;
  const float grad = t < FA_N ? grad_all[sys * FA_N + t] : 0.f;
  float acc[8][8];

  // ---- K0 = H + sigma I + A' diag(rho) A, inverted in X
  stage_rows(a, 0, X);
  stage_rows(a, FA_N, T);
  v.wv[t] = rho;
  __syncthreads();
  zero_acc(acc);
  gram_acc(X, v.wv, acc);
  gram_acc(T, v.wv + FA_N, acc);
  write_k(hess, p.sigma, acc, K);
  __syncthreads();
  jacobi_scale(K, v.d);
  fa_ns_schedule(K, X, T, p.s);
  unscale(X, v.d);

  // ---- ADMM iterations: A in K|T, the inverse in X
  stage_rows(a, 0, K);
  stage_rows(a, FA_N, T);
  float x = 0.f, z = 0.f, y = 0.f;
  for (int it = 0; it < p.n_iter; ++it) {
    v.mv[t] = rho * z - y;
    __syncthreads();
    const float at = at_matvec(K, T, v.mv, v.part);
    if (t < FA_N) v.xv[t] = (p.sigma * x - grad) + at;
    __syncthreads();
    const float xt = x_matvec(X, v.xv, v.part);
    if (t < FA_N) {
      v.xv[t] = xt;
      x = p.alpha * xt + (1.f - p.alpha) * x;
    }
    __syncthreads();
    const float zt = a_row(K, T, v.xv);
    const float z_relax = p.alpha * zt + (1.f - p.alpha) * z;
    const float z_new = fminf(fmaxf(z_relax + inv_rho * y, l), u);
    y = y + rho * (z_relax - z_new);
    z = z_new;
  }
  __syncthreads();  // every read of xv by the last iteration is done

  // ---- active-set polish: A in K|T at the top of every round
  auto violation = [&](float ax) {
    return fmaxf(l - ax, finite_u ? ax - u : -1.f);
  };
  bool lo = (z - l) < p.act_tol;
  bool hi = finite_u && ((u - z) < p.act_tol);
  float y_al = (lo || hi) ? y : 0.f;
  float best_x = x;
  if (t < FA_N) v.xv[t] = x;
  __syncthreads();
  float best_v = fmaxf(block_max(violation(a_row(K, T, v.xv)), v.red), 0.f);

  for (int round = 0; round < p.polish_rounds; ++round) {
    const bool act = lo || hi;
    const float bound = lo ? l : ((hi && finite_u) ? u : 0.f);
    const float w = act ? p.w_act : 0.f;
    const float y_act = act ? y_al : 0.f;
    v.mv[t] = w * bound - y_act;
    v.wv[t] = w;
    __syncthreads();
    const float b = -grad + at_matvec(K, T, v.mv, v.part);
    if (t < FA_N) v.bv[t] = b;
    // kp into X, scaled, inverted into K
    zero_acc(acc);
    gram_acc(K, v.wv, acc);
    gram_acc(T, v.wv + FA_N, acc);
    write_k(hess, p.sigma, acc, X);
    __syncthreads();
    jacobi_scale(X, v.d);
    fa_ns_schedule(X, K, T, p.s);
    unscale(K, v.d);
    // the unscaled kp again, into X, A staged through T half by half
    zero_acc(acc);
    stage_rows(a, 0, T);
    __syncthreads();
    gram_acc(T, v.wv, acc);
    __syncthreads();
    stage_rows(a, FA_N, T);
    __syncthreads();
    gram_acc(T, v.wv + FA_N, acc);
    write_k(hess, p.sigma, acc, X);
    __syncthreads();
    // x_p = invp b, then two refinement passes against kp
    float xp = x_matvec(K, v.bv, v.part);
    for (int r = 0; r < 2; ++r) {
      if (t < FA_N) v.xv[t] = xp;
      __syncthreads();
      const float kx = x_matvec(X, v.xv, v.part);
      if (t < FA_N) v.xv[t] = b - kx;
      __syncthreads();
      const float dx = x_matvec(K, v.xv, v.part);
      xp = xp + dx;
    }
    if (t < FA_N) v.xv[t] = xp;
    stage_rows(a, 0, K);
    __syncthreads();
    const float ax = a_row(K, T, v.xv);
    const float y_new = y_act + w * (ax - bound);
    const bool finite_p = __syncthreads_and(t >= FA_N || fabsf(xp) <= FLT_MAX_F);
    const float viol = block_max(violation(ax), v.red);
    const float v_p = finite_p ? viol : __int_as_float(0x7f800000);  // inf
    if (v_p < best_v) best_x = xp;
    best_v = fminf(v_p, best_v);
    lo = (lo && (y_new <= 1e-9f)) || (ax < l - 1e-6f);
    hi = (hi && (y_new >= -1e-9f)) || (finite_u && (ax > u + 1e-6f));
    y_al = (lo || hi) ? y_new : 0.f;
  }
  if (t < FA_N) x_out[sys * FA_N + t] = p.polish_rounds > 0 ? best_x : x;
}

}  // namespace qct

// C entry point (loaded with ctypes). Returns the launch's cudaError_t; the
// caller checks bounds, types and the schedule length.
extern "C" int qct_fused_admm_solve(const float* a, const float* hess, const float* grad,
                                    const float* l, const float* u, const float* rho, float* x,
                                    int b, const float* mus, int n_scaled, int n_quad, int n_hi,
                                    int n_iter, int polish_rounds, float sigma, float alpha,
                                    float w_act, float act_tol, float infty, void* stream) {
  if (n_scaled > qct::NS_MAX_MUS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(qct::fused_admm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(qct::FA_SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::FaParams p;
  p.s = qct::make_schedule(mus, n_scaled, n_quad, n_hi);
  p.n_iter = n_iter;
  p.polish_rounds = polish_rounds;
  p.sigma = sigma;
  p.alpha = alpha;
  p.w_act = w_act;
  p.act_tol = act_tol;
  p.infty = infty;
  qct::fused_admm_kernel<<<b, qct::NS_THREADS, qct::FA_SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(a, hess, grad, l, u, rho, x, p);
  return static_cast<int>(cudaGetLastError());
}
