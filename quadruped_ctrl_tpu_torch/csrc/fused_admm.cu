// The whole batched MPC QP solve in one launch, one block per system.
//
// fused_admm_kernel replaces the TPU kernel
//   quadruped_ctrl_tpu/ops/fused_admm.py: fused_admm_solve (_kernel)
//
// Per system: K = H + sigma I + A' diag(rho) A, Jacobi scale, the NS schedule,
// unscale; n_iter over-relaxed ADMM iterations against that inverse;
// polish_rounds active-set rounds, each building, scaling and inverting its
// own penalty matrix kp = H + sigma I + A' diag(w) A and solving with two
// refinement passes against kp. The arithmetic is the TPU kernel's (and
// fused_admm_solve_reference's); sums run in other orders, so results differ
// from it by rounding.
//
// The products. The five factorizations (1 + polish_rounds) run ns_core.cuh's
// ns_schedule: the bf16x3 steps as three mma.sync m16n8k16 bf16 passes, the
// fp32 tail as 3xTF32 with a fresh accumulator per 16 k added in fp32. The
// Grams A' diag(w) A (fp32 in the reference) run on the tensor cores the same
// way as the tail (gram_half): the mma's k is A's row, its A operand A read
// transposed, its B operand w A; the swizzle makes both reads free of bank
// conflicts. Every matvec stays fp32 on the CUDA cores.
//
// Residency. The NsTiles layout of ns_core.cuh: K, X and T, 128 x 128 fp32
// tiles, unpadded, columns XOR-swizzled by 8 (row % 4) (sw<NS_N>), and the
// two-chunk bf16 staging ring S of the bf16x3 products (212,992 bytes), then
// FaVecs (7,712 bytes): 220,704 bytes of dynamic shared memory, one block
// per SM. The roles of the tiles rotate; the constraint matrix A (256 x 128,
// shared by every system and hot in L2) goes in as two 128-row halves in the
// swizzled layout, staged with __ldg float4 loads whenever tiles are free:
//   build    A in X|T -> K = H + sigma I + gram(rho), scaled in K
//   NS       ns_schedule(K, X, T, S) -> X = inverse, unscaled in place
//   ADMM     A in K|T, the inverse in X, the ring idle; every matvec reads
//            shared memory
//   round    A in K|T -> b = -g + A'(w bound - y); kp built into X, scaled;
//            ns_schedule(X, K, T, S) -> K = inverse, unscaled; kp rebuilt
//            unscaled into X with A staged through T half by half; the
//            refinement matvecs read K and X; A's first half is staged into
//            K again, so A is in K|T for Ax and for the next round.
// A is never assumed to have the pyramid's structure.
//
// The matvecs are warp-wide: a warp owns a set of rows, its 32 lanes a float4
// of each row (32 consecutive float4 of a swizzled row fall in distinct
// banks), and a shuffle tree that halves the rows a lane holds at each step
// (warp_sum_rows) sums them. inv @ v and kp @ v read rows (the NS inverse is
// not exactly symmetric in fp32); A'v sums A's rows, a warp 32 of them, the
// 8 warps' partial sums added through shared memory. Vectors in x space live
// in registers as each lane's float4, alike in all 8 warps; those in
// constraint space one entry a thread, thread t owning row t of A. An ADMM
// iteration takes three block barriers.
//
// What bounds it, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6;
// chip_smoke.py): 19.75 ms for 2048 systems of the h=10 fused path, 0.23 of
// its bound (4.54 ms). The five factorizations (22 bf16x3 and 2 tail
// products each) are ~58% of it, bound as ns_core.cuh's are by the operand
// splits and shared memory loads around the mmas; the nine Grams ~18%; the
// 120 ADMM iterations ~19% (2.07 us each a wave of 132 systems), bound by
// the 320 KiB of shared memory they read an iteration at one block per SM.
#include <cuda_bf16.h>

#include <cstdint>

#include "ns_core.cuh"

namespace qct {

constexpr int FA_N = NS_N;        // padded variable count
constexpr int FA_M = 256;         // padded constraint-row count
constexpr float FLT_MAX_F = 3.402823466e38f;  // |v| <= it: v is finite
static_assert(NS_THREADS == FA_M, "one thread per constraint row");
static_assert(FA_M == 32 * WARPS && FA_N == 16 * WARPS, "the matvecs' rows per warp");

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

// Shared vectors after the staging ring, each 16-byte aligned.
struct FaVecs {
  float part[WARPS][FA_N];  // each warp's partial sums of A'v
  float xv[2][FA_N];        // x-space matvec results, the two used in turn
  float mv[FA_M];           // constraint-space operand of A'v
  float wv[FA_M];           // Gram weights
  float d[FA_N];            // Jacobi scale of the matrix being inverted
  float red[WARPS];
};
constexpr size_t FA_SMEM_BYTES = NS_SMEM_BYTES + sizeof(FaVecs);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// Rows [row0, row0 + 128) of A (M x N, row-major, global) into the swizzled
// tile dst, a float4 a thread.
__device__ __forceinline__ void stage_rows(const float* __restrict__ a, int row0, float* dst) {
  const float4* src = reinterpret_cast<const float4*>(a + static_cast<size_t>(row0) * FA_N);
  for (int idx = threadIdx.x; idx < NS_TILE / 4; idx += NS_THREADS) {
    const int r = idx / (NS_N / 4), c = 4 * (idx % (NS_N / 4));
    *reinterpret_cast<float4*>(dst + sw<NS_N>(r, c)) = __ldg(src + idx);
  }
}

// acc += Ah' diag(w) Ah for one half of A: Ah its 128 rows (a swizzled tile),
// w their weights; the warp's 32 x 64 tile of the N x N result. 3xTF32 as in
// mma_chunk_tf32: the mma's k is A's row m, 16 rows per fresh accumulator.
// The A operand is Ah transposed, element (i, m) = Ah[m][i]; the B operand
// w[m] Ah[m][j]. Lane (g, t) reads rows m = t and t + 4 (mod 8) at columns
// 8-groups apart, swizzled by 8 t: 32 distinct banks.
__device__ __forceinline__ void gram_half(const float* Ah, const float* w, const NsLane& ln,
                                          Acc& acc) {
  for (int kc = 0; kc < NS_N; kc += KC) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float part[8][4] = {};
#pragma unroll
      for (int kk = 0; kk < KC; kk += 8) {
        const int m0 = kc + kk + ln.t, m1 = m0 + 4;  // k of a0, a1, b0 and of a2, a3, b1
        uint32_t ah[4], al[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {  // a0..a3: rows g, g+8 of k = t and t+4
          split_tf32(Ah[sw<NS_N>((f >> 1) ? m1 : m0, ln.row(mt, f & 1))], ah[f], al[f]);
        }
        const float w0 = w[m0], w1 = w[m1];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int sn = (64 * ln.wn + 8 * nt + ln.g) ^ (ln.t << 3);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(w0 * Ah[m0 * NS_N + sn], bh0, bl0);
          split_tf32(w1 * Ah[m1 * NS_N + sn], bh1, bl1);
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
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// dst = (H + sigma I) + acc, the warp's tile of the accumulator layout into
// the swizzled tile dst.
__device__ __forceinline__ void write_k(const float* __restrict__ hess, float sigma,
                                        const Acc& acc, float* dst) {
  const NsLane ln;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = ln.row(mt, h), j = ln.col(nt);
        const float2 hv = *reinterpret_cast<const float2*>(hess + i * FA_N + j);
        float2 v;
        v.x = (hv.x + (i == j ? sigma : 0.f)) + acc[mt][nt][2 * h];
        v.y = (hv.y + (i == j + 1 ? sigma : 0.f)) + acc[mt][nt][2 * h + 1];
        *reinterpret_cast<float2*>(dst + sw<NS_N>(i, j)) = v;
      }
}

// Mat <- Mat_ij d_j d_i on the swizzled tile, then a barrier.
__device__ __forceinline__ void scale_tile(float* Mat, const float* d) {
  for (int idx = threadIdx.x; idx < NS_TILE / 4; idx += NS_THREADS) {
    const int r = idx / (NS_N / 4), c = 4 * (idx % (NS_N / 4));
    float4& v = *reinterpret_cast<float4*>(Mat + sw<NS_N>(r, c));
    const float4 dc = ld4(d + c);
    const float dr = d[r];
    v.x = v.x * dc.x * dr;
    v.y = v.y * dc.y * dr;
    v.z = v.z * dc.z * dr;
    v.w = v.w * dc.w * dr;
  }
  __syncthreads();
}

// d = rsqrt(max(diag K, 1e-30)), K <- K * d_j * d_i.
__device__ __forceinline__ void jacobi_scale(float* K, float* d) {
  if (threadIdx.x < FA_N) {
    d[threadIdx.x] = 1.f / sqrtf(fmaxf(K[sw<NS_N>(threadIdx.x, threadIdx.x)], 1e-30f));
  }
  __syncthreads();
  scale_tile(K, d);
}

// Sums each of the R (16 or 32) row partials v holds over the warp's 32
// lanes. Each step a lane keeps half of its rows and adds the other lane's
// partials of them (lane ^ mask), sending its own of the half it gives up:
// R - 1 shuffles in all, and one more at R = 16. Returns row lane at R = 32,
// row lane / 2 at R = 16. v is clobbered.
template <int R, int kHalf = R / 2>
__device__ __forceinline__ float warp_sum_rows(float (&v)[R]) {
  if constexpr (kHalf == 0) {
    float s = v[0];
#pragma unroll
    for (int mask = 16 / R; mask > 0; mask >>= 1) s += __shfl_xor_sync(0xffffffffu, s, mask);
    return s;
  } else {
    constexpr int mask = kHalf * (32 / R);
    const bool upper = (threadIdx.x & mask) != 0;
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const float send = upper ? v[k] : v[k + kHalf];
      const float keep = upper ? v[k + kHalf] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
    }
    return warp_sum_rows<R, kHalf / 2>(v);
  }
}

// (Mat v)_i for the swizzled N x N tile Mat, vr this lane's v[4 lane..+3]:
// warp w sums rows 16w..16w+15; the even lanes write them to out. The
// caller's barrier comes before out is read.
__device__ __forceinline__ void x_matvec(const float* Mat, const float4& vr, float* out) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float s[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) s[r] = dot4(ld4(Mat + sw<NS_N>(16 * w + r, 4 * lane)), vr);
  const float y = warp_sum_rows<16>(s);
  if (!(lane & 1)) out[16 * w + (lane >> 1)] = y;
}

// (A x)_t on thread t, xr this lane's x[4 lane..+3]: warp w sums A's rows
// 32w..32w+31 (rows [0,128) in A0, [128,256) in A1).
__device__ __forceinline__ float a_matvec(const float* A0, const float* A1, const float4& xr) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float* Ah = w < WARPS / 2 ? A0 : A1;
  const int r0 = 32 * (w % (WARPS / 2));
  float s[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) s[r] = dot4(ld4(Ah + sw<NS_N>(r0 + r, 4 * lane)), xr);
  return warp_sum_rows<32>(s);
}

// Warp w's share of A'v: sum over A's rows m = 32w..32w+31 of v[m] A[m, :],
// columns 4 lane..+3 on each lane, into part[w].
__device__ __forceinline__ void at_partial(const float* A0, const float* A1, const float* v,
                                           float (*part)[FA_N]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float* Ah = w < WARPS / 2 ? A0 : A1;
  const int r0 = 32 * (w % (WARPS / 2));
  float4 s = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int r = 0; r < 32; ++r) {
    const float vm = v[32 * w + r];
    const float4 a = ld4(Ah + sw<NS_N>(r0 + r, 4 * lane));
    s.x = fmaf(a.x, vm, s.x);
    s.y = fmaf(a.y, vm, s.y);
    s.z = fmaf(a.z, vm, s.z);
    s.w = fmaf(a.w, vm, s.w);
  }
  *reinterpret_cast<float4*>(part[w] + 4 * lane) = s;
}

// (A'v)[4 lane..+3]: the warps' partial sums, after the barrier that ends
// at_partial.
__device__ __forceinline__ float4 at_sum(const float (*part)[FA_N]) {
  const int lane = threadIdx.x & 31;
  float4 s = ld4(part[0] + 4 * lane);
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    const float4 a = ld4(part[w] + 4 * lane);
    s.x += a.x;
    s.y += a.y;
    s.z += a.z;
    s.w += a.w;
  }
  return s;
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

// a (M, N) shared; hess (B, N, N); grad (B, N); l, u, rho (B, M) -> x (B, N).
__global__ void __launch_bounds__(NS_THREADS)
fused_admm_kernel(const float* __restrict__ a, const float* __restrict__ hess_all,
                  const float* __restrict__ grad_all, const float* __restrict__ l_all,
                  const float* __restrict__ u_all, const float* __restrict__ rho_all,
                  float* __restrict__ x_out, FaParams p) {
  extern __shared__ __align__(16) float smem[];
  const NsTiles m(smem);
  float* K = m.K;
  float* X = m.X;
  float* T = m.T;
  FaVecs& v = *reinterpret_cast<FaVecs*>(smem + NS_SMEM_BYTES / sizeof(float));
  const NsLane ln;
  const int t = threadIdx.x, lane = t & 31;
  const size_t sys = blockIdx.x;
  const float* hess = hess_all + sys * FA_N * FA_N;

  // row t of the constraints on thread t; x-space vectors as this lane's float4
  const float l = l_all[sys * FA_M + t];
  const float u = u_all[sys * FA_M + t];
  const float rho = rho_all[sys * FA_M + t];
  const float inv_rho = 1.f / rho;
  const bool finite_u = u < p.infty;
  const float4 g4 = __ldg(reinterpret_cast<const float4*>(grad_all + sys * FA_N) + lane);
  Acc acc;

  // ---- K0 = H + sigma I + A' diag(rho) A, inverted in X
  stage_rows(a, 0, X);
  stage_rows(a, FA_N, T);
  v.wv[t] = rho;
  __syncthreads();
  zero_acc(acc);
  gram_half(X, v.wv, ln, acc);
  gram_half(T, v.wv + FA_N, ln, acc);
  write_k(hess, p.sigma, acc, K);
  __syncthreads();
  jacobi_scale(K, v.d);
  ns_schedule(K, X, T, m.S, p.s);
  scale_tile(X, v.d);

  // ---- ADMM iterations: A in K|T, the inverse in X
  stage_rows(a, 0, K);
  stage_rows(a, FA_N, T);
  float4 x = {0.f, 0.f, 0.f, 0.f};
  float z = 0.f, y = 0.f;
  for (int it = 0; it < p.n_iter; ++it) {
    v.mv[t] = rho * z - y;
    __syncthreads();  // mv complete (and, at it = 0, A staged)
    at_partial(K, T, v.mv, v.part);
    __syncthreads();
    const float4 at = at_sum(v.part);
    float4 rhs;
    rhs.x = (p.sigma * x.x - g4.x) + at.x;
    rhs.y = (p.sigma * x.y - g4.y) + at.y;
    rhs.z = (p.sigma * x.z - g4.z) + at.z;
    rhs.w = (p.sigma * x.w - g4.w) + at.w;
    x_matvec(X, rhs, v.xv[0]);
    __syncthreads();
    const float4 xt = ld4(v.xv[0] + 4 * lane);
    x.x = p.alpha * xt.x + (1.f - p.alpha) * x.x;
    x.y = p.alpha * xt.y + (1.f - p.alpha) * x.y;
    x.z = p.alpha * xt.z + (1.f - p.alpha) * x.z;
    x.w = p.alpha * xt.w + (1.f - p.alpha) * x.w;
    const float zt = a_matvec(K, T, xt);
    const float z_relax = p.alpha * zt + (1.f - p.alpha) * z;
    const float z_new = fminf(fmaxf(z_relax + inv_rho * y, l), u);
    y = y + rho * (z_relax - z_new);
    z = z_new;
  }
  __syncthreads();  // A staged, when n_iter = 0

  // ---- active-set polish: A in K|T at the top of every round
  auto violation = [&](float ax) {
    return fmaxf(l - ax, finite_u ? ax - u : -1.f);
  };
  bool lo = (z - l) < p.act_tol;
  bool hi = finite_u && ((u - z) < p.act_tol);
  float y_al = (lo || hi) ? y : 0.f;
  float4 best_x = x;
  float best_v = fmaxf(block_max(violation(a_matvec(K, T, x)), v.red), 0.f);

  for (int round = 0; round < p.polish_rounds; ++round) {
    const bool act = lo || hi;
    const float bound = lo ? l : ((hi && finite_u) ? u : 0.f);
    const float w = act ? p.w_act : 0.f;
    const float y_act = act ? y_al : 0.f;
    v.mv[t] = w * bound - y_act;
    v.wv[t] = w;
    __syncthreads();
    // b = -g + A'(w bound - y_act); kp into X
    at_partial(K, T, v.mv, v.part);
    zero_acc(acc);
    gram_half(K, v.wv, ln, acc);
    gram_half(T, v.wv + FA_N, ln, acc);
    write_k(hess, p.sigma, acc, X);
    __syncthreads();  // part and kp complete; every read of A done
    const float4 at = at_sum(v.part);
    float4 b;
    b.x = -g4.x + at.x;
    b.y = -g4.y + at.y;
    b.z = -g4.z + at.z;
    b.w = -g4.w + at.w;
    // kp scaled, inverted into K, unscaled
    jacobi_scale(X, v.d);
    ns_schedule(X, K, T, m.S, p.s);
    scale_tile(K, v.d);
    // the unscaled kp again, into X, A staged through T half by half
    stage_rows(a, 0, T);
    __syncthreads();
    zero_acc(acc);
    gram_half(T, v.wv, ln, acc);
    __syncthreads();
    stage_rows(a, FA_N, T);
    __syncthreads();
    gram_half(T, v.wv + FA_N, ln, acc);
    write_k(hess, p.sigma, acc, X);
    __syncthreads();
    // x_p = invp b, then two refinement passes against kp; each matvec's
    // result goes to the other xv buffer than the one before it
    x_matvec(K, b, v.xv[0]);
    __syncthreads();
    float4 xp = ld4(v.xv[0] + 4 * lane);
    for (int r = 0; r < 2; ++r) {
      x_matvec(X, xp, v.xv[1]);
      __syncthreads();
      const float4 kx = ld4(v.xv[1] + 4 * lane);
      float4 res;
      res.x = b.x - kx.x;
      res.y = b.y - kx.y;
      res.z = b.z - kx.z;
      res.w = b.w - kx.w;
      x_matvec(K, res, v.xv[0]);
      __syncthreads();
      const float4 dx = ld4(v.xv[0] + 4 * lane);
      xp.x = xp.x + dx.x;
      xp.y = xp.y + dx.y;
      xp.z = xp.z + dx.z;
      xp.w = xp.w + dx.w;
    }
    stage_rows(a, 0, K);
    __syncthreads();
    const float ax = a_matvec(K, T, xp);
    const float y_new = y_act + w * (ax - bound);
    const bool finite_p = __syncthreads_and(fabsf(xp.x) <= FLT_MAX_F && fabsf(xp.y) <= FLT_MAX_F &&
                                            fabsf(xp.z) <= FLT_MAX_F && fabsf(xp.w) <= FLT_MAX_F);
    const float viol = block_max(violation(ax), v.red);
    const float v_p = finite_p ? viol : __int_as_float(0x7f800000);  // inf
    if (v_p < best_v) best_x = xp;
    best_v = fminf(v_p, best_v);
    lo = (lo && (y_new <= 1e-9f)) || (ax < l - 1e-6f);
    hi = (hi && (y_new >= -1e-9f)) || (finite_u && (ax > u + 1e-6f));
    y_al = (lo || hi) ? y_new : 0.f;
  }
  if (t < 32) reinterpret_cast<float4*>(x_out + sys * FA_N)[lane] = best_x;
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
