// One ADMM segment of the batched MPC solve for every system, in one launch.
//
// admm_segment_kernel replaces no TPU kernel: the JAX package runs the
// batched iterate as a lax.scan of XLA ops over tile-padded vectors
// (quadruped_ctrl_tpu/solver/admm.py, admm_mpc_batched's mk_body), which
// ops/admm_segment.admm_segment_reference repeats op for op. Run as ops, each
// iteration streamed every system's padded inverse from device memory (2048 x
// 256^2 or 8192 x 128^2 fp32, ~537 MB) and took ~22 launches; a segment is 60
// iterations against one inverse. Here a block holds one system for the whole
// segment: the true n x n block of its inverse is read from device memory
// once (twice where the segment switches from bf16 to fp32 products) into
// shared memory, x, z and y stay on chip, and two block barriers separate the
// phases of an iteration.
//
// An iteration is admm_segment_reference's, in its order:
//   rhs = sigma x - g + A'(rho z - y)      (bf16-rounded in the bf16 iterations)
//   x_t = inv rhs
//   z_t = A x_t
//   x   = alpha x_t + (1 - alpha) x
//   z_r = alpha z_t + (1 - alpha) z
//   z'  = clamp(z_r + y / rho, l, u);  y += rho (z_r - z');  z = z'
// Every product and sum is rounded where the reference rounds it (the
// __f*_rn intrinsics keep the compiler from contracting them); the sums of
// the two matrix products run in another order than cuBLAS's.
//
// The products' precision is the reference's: in the first n_lo iterations
// both factors of inv rhs are bf16 values held in fp32 (the inverse rounded
// as it is loaded, rhs as it is formed), so each product is exact and the
// sum is fp32; in the n_hi iterations after them, fp32 x fp32 from a fresh
// load of the unrounded inverse.
//
// A is the friction pyramid of friction coefficient mu: its leading 5 n/3 x n
// is block diagonal in one 5 x 3 block (solver/admm.py's _pyramid_dense),
// built in registers from 1 / mu; the rest of A is zero. Thread b < n/3 owns
// block b: its 3 variables and 5 rows, with x, z, y, rho, l and u in
// registers. It sums x_t from the matvec's partial sums, updates its rows and
// forms the next rhs, which the matvec reads from shared memory.
//
// The matvec. The inverse lies in shared memory row-major with a row stride
// of ld4 float4, ld4 odd, so that the float4 reads of 8 consecutive rows at
// one column fall in distinct banks. Thread t takes row t % nr and column
// chunk t / nr (k4 float4 wide) and sums its products in order into one
// fp32 accumulator; thread b adds the q chunks' sums in chunk order.
//
// The carry's padding. x beyond n and z, y beyond 5 n/3 are zero in the
// solver's carry and stay zero in the reference (zero A rows and columns,
// l = u = 0 and rho = 1 there, and an inverse with no coupling between the
// true block and its pad); the kernel writes zeros there.
//
// What bounds it (PERF.md, section 6): a system's iteration reads its n^2
// inverse from shared memory, 147,456 bytes at n = 192, 128 bytes a clock
// of an SM: ~1,150 clocks, with one block an SM at n = 192 (154,368 bytes of
// shared memory), two at n = 144, three at n = 120, so that one block's
// barriers and serial row updates hide behind another's matvec where the
// shared memory leaves room.
#include <cuda_bf16.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace qct {

constexpr int AS_SMEM_MAX = 232448;     // shared memory a block may have
constexpr int AS_SM_SMEM = 233472;      // an SM's, 1,024 bytes of it reserved per block
constexpr int AS_SM_THREADS = 768;      // the threads aimed at on an SM
constexpr int AS_QMAX = 4;              // column chunks of the matvec at most

struct AsShape {
  int n;        // variables, a multiple of 3
  int m;        // constraint rows, 5 n / 3
  int c4;       // float4 of a row's n columns, the last one zero-filled
  int ld4;      // the shared inverse's row stride in float4, odd
  int nr;       // rows rounded up to a warp
  int q;        // column chunks of the matvec
  int k4;       // float4 a chunk
  int threads;  // nr q
  int smem;     // bytes of shared memory
};

// The shape of a segment at n variables; threads is 0 where n is refused:
// no positive multiple of 3, or a block larger than shared memory holds.
inline AsShape as_shape(int n) {
  AsShape s{};
  if (n <= 0 || n % 3 != 0) return s;
  s.n = n;
  s.m = 5 * (n / 3);
  s.c4 = (n + 3) / 4;
  s.ld4 = s.c4 | 1;
  s.nr = (n + 31) / 32 * 32;
  const long floats = 4L * n * s.ld4 + 4L * s.c4 + static_cast<long>(AS_QMAX) * s.nr;
  s.smem = static_cast<int>(4 * floats);
  if (s.smem > AS_SMEM_MAX || s.nr > 256) return s;
  const int blocks = AS_SM_SMEM / (s.smem + 1024);   // blocks an SM holds
  int q = AS_SM_THREADS / (blocks * s.nr);
  q = q < 1 ? 1 : (q > AS_QMAX ? AS_QMAX : q);
  q = q > s.c4 ? s.c4 : q;
  s.k4 = (s.c4 + q - 1) / q;
  s.q = (s.c4 + s.k4 - 1) / s.k4;
  s.threads = s.nr * s.q;
  return s;
}

struct AsArgs {
  const float* inv;    // (b, np, np) the Jacobi-folded inverse; its [:n, :n] is read
  const float* grad;   // (b, np)
  const float* l;      // (b, mp)
  const float* u;      // (b, mp)
  const float* rho;    // (b, mp)
  const float* x0;     // (b, np) the carry in
  const float* z0;     // (b, mp)
  const float* y0;     // (b, mp)
  float* x;            // (b, np) the carry out
  float* z;            // (b, mp)
  float* y;            // (b, mp)
  int np, mp;
  AsShape s;
  float sigma, alpha, oma;   // oma: 1 - alpha as the reference rounds it
  float mu_inv;              // 1 / mu, the pyramid's slope
  int n_lo, n_hi;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The system's inverse into shared memory, rounded to bf16 values if `round`.
__device__ void as_load_inverse(const AsArgs& p, float* inv_s, bool round) {
  const AsShape& s = p.s;
  const float* src = p.inv + static_cast<size_t>(blockIdx.x) * p.np * p.np;
  float4* dst = reinterpret_cast<float4*>(inv_s);
  for (int idx = threadIdx.x; idx < s.n * s.c4; idx += s.threads) {
    const int r = idx / s.c4, c = idx - r * s.c4;
    float4 v = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * p.np) + c);
    const int j = 4 * c;
    if (j + 1 >= s.n) v.y = 0.0f;
    if (j + 2 >= s.n) v.z = 0.0f;
    if (j + 3 >= s.n) v.w = 0.0f;
    if (round) v = make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z), bf16_round(v.w));
    dst[r * s.ld4 + c] = v;
  }
}

// Block b's part of rhs = sigma x - g + A'(rho z - y), A' summed over its 5
// rows in order; into rhs_s, bf16-rounded if `round`.
__device__ __forceinline__ void as_rhs(const AsArgs& p, const float* cf, const float (&x)[3],
                                       const float (&g)[3], const float (&z)[5],
                                       const float (&y)[5], const float (&rho)[5], bool round,
                                       float* rhs) {
  float w[5];
#pragma unroll
  for (int r = 0; r < 5; ++r) w[r] = __fsub_rn(__fmul_rn(rho[r], z[r]), y[r]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float atw = 0.0f;
#pragma unroll
    for (int r = 0; r < 5; ++r) atw = __fmaf_rn(w[r], cf[3 * r + k], atw);
    const float v = __fadd_rn(__fsub_rn(__fmul_rn(p.sigma, x[k]), g[k]), atw);
    rhs[k] = round ? bf16_round(v) : v;
  }
}

__global__ void __launch_bounds__(AS_SM_THREADS, 1) admm_segment_kernel(
    const __grid_constant__ AsArgs p) {
  extern __shared__ __align__(16) float as_smem[];
  const AsShape& s = p.s;
  float* inv_s = as_smem;                         // n x 4 ld4
  float* rhs_s = inv_s + 4 * s.n * s.ld4;         // 4 c4, zero beyond n
  float* part_s = rhs_s + 4 * s.c4;               // AS_QMAX x nr
  const int t = threadIdx.x;
  const int nb = s.n / 3;
  const int total = p.n_lo + p.n_hi;
  const size_t sys = blockIdx.x;

  as_load_inverse(p, inv_s, p.n_lo > 0);
  for (int j = s.n + t; j < 4 * s.c4; j += s.threads) rhs_s[j] = 0.0f;

  // the pyramid's block (row-major 5 x 3); block b's state, l and u
  const float mi = p.mu_inv;
  const float cf[15] = {mi, 0.0f, 1.0f, -mi, 0.0f, 1.0f, 0.0f, mi, 1.0f, 0.0f, -mi, 1.0f,
                        0.0f, 0.0f, 1.0f};
  float x[3], g[3], z[5], y[5], rho[5], irho[5], lo[5], hi[5];
  if (t < nb) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      x[k] = p.x0[sys * p.np + 3 * t + k];
      g[k] = p.grad[sys * p.np + 3 * t + k];
    }
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const size_t row = sys * p.mp + 5 * t + r;
      z[r] = p.z0[row];
      y[r] = p.y0[row];
      rho[r] = p.rho[row];
      irho[r] = __fdiv_rn(1.0f, rho[r]);
      lo[r] = p.l[row];
      hi[r] = p.u[row];
    }
    float rhs[3];
    as_rhs(p, cf, x, g, z, y, rho, p.n_lo > 0, rhs);
#pragma unroll
    for (int k = 0; k < 3; ++k) rhs_s[3 * t + k] = rhs[k];
  }

  const int row = t % s.nr, chunk = t / s.nr;
  const int c_lo = chunk * s.k4, c_hi = min(s.c4, c_lo + s.k4);
  const float4* inv4 = reinterpret_cast<const float4*>(inv_s) + row * s.ld4;
  const float4* rhs4 = reinterpret_cast<const float4*>(rhs_s);
  for (int it = 0; it < total; ++it) {
    if (it == p.n_lo && it > 0) as_load_inverse(p, inv_s, false);
    __syncthreads();   // rhs (and the inverse) in place
    if (row < s.n) {
      float acc = 0.0f;
      for (int c = c_lo; c < c_hi; ++c) {
        const float4 a = inv4[c], r = rhs4[c];
        acc = __fmaf_rn(a.x, r.x, acc);
        acc = __fmaf_rn(a.y, r.y, acc);
        acc = __fmaf_rn(a.z, r.z, acc);
        acc = __fmaf_rn(a.w, r.w, acc);
      }
      part_s[chunk * s.nr + row] = acc;
    }
    __syncthreads();   // the partial sums in place
    if (t < nb) {
      float xt[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float v = part_s[3 * t + k];
        for (int c = 1; c < s.q; ++c) v = __fadd_rn(v, part_s[c * s.nr + 3 * t + k]);
        xt[k] = v;
        x[k] = __fadd_rn(__fmul_rn(p.alpha, v), __fmul_rn(p.oma, x[k]));
      }
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        float zt = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) zt = __fmaf_rn(xt[k], cf[3 * r + k], zt);
        const float zr = __fadd_rn(__fmul_rn(p.alpha, zt), __fmul_rn(p.oma, z[r]));
        const float v = __fadd_rn(zr, __fmul_rn(irho[r], y[r]));
        const float zn = isnan(v) ? v : fminf(fmaxf(v, lo[r]), hi[r]);
        y[r] = __fadd_rn(y[r], __fmul_rn(rho[r], __fsub_rn(zr, zn)));
        z[r] = zn;
      }
      if (it + 1 < total) {
        float rhs[3];
        as_rhs(p, cf, x, g, z, y, rho, it + 1 < p.n_lo, rhs);
#pragma unroll
        for (int k = 0; k < 3; ++k) rhs_s[3 * t + k] = rhs[k];
      }
    }
  }

  if (t < nb) {
#pragma unroll
    for (int k = 0; k < 3; ++k) p.x[sys * p.np + 3 * t + k] = x[k];
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      p.z[sys * p.mp + 5 * t + r] = z[r];
      p.y[sys * p.mp + 5 * t + r] = y[r];
    }
  }
  for (int j = s.n + t; j < p.np; j += s.threads) p.x[sys * p.np + j] = 0.0f;
  for (int j = s.m + t; j < p.mp; j += s.threads) {
    p.z[sys * p.mp + j] = 0.0f;
    p.y[sys * p.mp + j] = 0.0f;
  }
}

}  // namespace qct

// Threads of a block at n variables; 0 where qct_admm_segment refuses n (no
// positive multiple of 3, or a block that does not fit in shared memory).
// ops/admm_segment.fits routes on it.
extern "C" int qct_admm_segment_threads(int n) {
  const qct::AsShape s = qct::as_shape(n);
  return qct::as_shape(n).threads;
}

extern "C" int qct_admm_segment(const float* inv, const float* grad, const float* l,
                                const float* u, const float* rho, const float* x0,
                                const float* z0, const float* y0, float* x, float* z, float* y,
                                int b, int n, int np, int mp, float sigma, float alpha,
                                float oma, float mu_inv, int n_lo, int n_hi, void* stream) {
  const qct::AsShape s = qct::as_shape(n);
  if (s.threads == 0 || np < 4 * s.c4 || mp < s.m || np % 4 != 0 || n_lo < 0 || n_hi < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(qct::admm_segment_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  qct::AsArgs p{inv, grad, l, u, rho, x0, z0, y0, x, z, y, np, mp, s, sigma, alpha, oma,
                mu_inv, n_lo, n_hi};
  qct::admm_segment_kernel<<<b, s.threads, s.smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
