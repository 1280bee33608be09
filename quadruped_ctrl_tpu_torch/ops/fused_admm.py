"""The whole batched MPC QP solve in one kernel launch (kernel K5).

The counterpart of `quadruped_ctrl_tpu/ops/fused_admm.py`. Per system it

  1. builds K = H + sigma I + A' diag(rho) A,
  2. Jacobi-scales K and inverts it by the scaled mixed-precision
     Newton-Schulz schedule of `ops/ns_inverse.py`,
  3. runs `n_iter` over-relaxed ADMM iterations against that inverse,
  4. runs `polish_rounds` active-set polish rounds, each building and
     inverting its own penalty matrix (AL dual correction, wrong-sign drops,
     violated-row adds, least-infeasible iterate tracking),

with the semantics of `solver/admm.py:admm_mpc_batched` at a fixed rho. On a
CUDA tensor `fused_admm_solve` launches `csrc/fused_admm.cu` (one block per
system, K, the inverse, one scratch tile and the constraint matrix in shared
memory for the whole solve; the five factorizations and the Grams on the
tensor cores through `csrc/ns_core.cuh`, the matvecs warp-wide in fp32); on a
CPU tensor it runs `fused_admm_solve_reference`, the same arithmetic in plain
PyTorch, batched over the systems.

Shapes are the TPU kernel's tile: N = 128 variables, M = 256 constraint
rows. The TPU kernel runs G = 8 systems per grid step and needs the batch
padded to a multiple of G; the CUDA kernel takes any batch. `G` stays because
the solver pads its batch as the JAX solver does.
"""

from __future__ import annotations

import torch

from quadruped_ctrl_tpu_torch.ops import _build, _launch
from quadruped_ctrl_tpu_torch.ops import ns_inverse as NI
from quadruped_ctrl_tpu_torch.utils.timer import span

N = 128   # padded variable count
M = 256   # padded constraint-row count
G = 8     # systems per TPU grid step; the solver's batch padding


def _inverse_of(k: torch.Tensor, mus, n_quad: int, n_hi: int) -> torch.Tensor:
    """Jacobi prescale, the NS schedule and unscale: the inverse of a batch of
    SPD matrices (B, N, N)."""
    d = torch.rsqrt(torch.clamp(torch.diagonal(k, dim1=-2, dim2=-1), min=1e-30))
    ks = k * d[:, None, :] * d[:, :, None]
    x = NI._ns_schedule(ks, mus, n_quad, n_hi)
    return x * d[:, None, :] * d[:, :, None]


def _bmv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.bmm(a, v[:, :, None])[:, :, 0]


def fused_admm_solve_reference(a_dense, hess, grad, l, u, rho, *,
                               mus_a0=1e-5, n_scaled=9, n_quad=2, n_hi=2,
                               n_iter=250, polish_rounds=4, sigma=1e-6,
                               alpha_rx=1.6, w_act=1e4, act_tol=1e-4,
                               infty=1e10):
    """Plain PyTorch K5, batched over the systems: the TPU kernel's
    per-system arithmetic with every product in fp32 and the NS schedule of
    `ops/ns_inverse.py` (bf16x3 steps, fp32 tail)."""
    mus = NI.mu_schedule(mus_a0, n_scaled)
    eye = torch.eye(N, dtype=torch.float32, device=hess.device)

    def gram(w):
        """A' diag(w) A for w (B, M) -> (B, N, N)."""
        return (a_dense * w[:, :, None]).transpose(1, 2) @ a_dense

    def apply_a(v):
        return v @ a_dense.T

    def apply_at(w):
        return w @ a_dense

    inv_rho = 1.0 / rho
    finite_u = u < infty

    inv0 = _inverse_of(hess + sigma * eye + gram(rho), mus, n_quad, n_hi)

    # ADMM iterations (solver/admm.py:_iterate)
    x = torch.zeros_like(grad)
    z = torch.zeros_like(l)
    y = torch.zeros_like(l)
    for _ in range(n_iter):
        rhs = sigma * x - grad + apply_at(rho * z - y)
        x_t = _bmv(inv0, rhs)
        z_t = apply_a(x_t)
        x = alpha_rx * x_t + (1.0 - alpha_rx) * x
        z_relax = alpha_rx * z_t + (1.0 - alpha_rx) * z
        z_new = torch.clamp(z_relax + inv_rho * y, min=l, max=u)
        y = y + rho * (z_relax - z_new)
        z = z_new

    # active-set polish (solver/admm.py:_polish)
    def viol(vec):
        av = apply_a(vec)
        per = torch.maximum(l - av, torch.where(finite_u, av - u, -1.0))
        return per.amax(-1)

    lo = (z - l) < act_tol
    hi = finite_u & ((u - z) < act_tol)
    y_al = torch.where(lo | hi, y, 0.0)
    best_x = x
    best_v = torch.clamp(viol(x), min=0.0)
    for _ in range(polish_rounds):
        act = lo | hi
        bound = torch.where(lo, l, torch.where(hi & finite_u, u, 0.0))
        w = torch.where(act, w_act, 0.0)
        kp = hess + sigma * eye + gram(w)
        invp = _inverse_of(kp, mus, n_quad, n_hi)
        y_act = torch.where(act, y_al, 0.0)
        b = -grad + apply_at(w * bound - y_act)
        x_p = _bmv(invp, b)
        for _r in range(2):                          # iterative refinement
            x_p = x_p + _bmv(invp, b - _bmv(kp, x_p))
        ax = apply_a(x_p)
        y_new = y_act + w * (ax - bound)
        finite_p = torch.isfinite(x_p).all(-1)
        v_p = torch.where(finite_p, viol(x_p), torch.inf)
        take = v_p < best_v
        best_x = torch.where(take[:, None], x_p, best_x)
        best_v = torch.minimum(v_p, best_v)
        lo = (lo & (y_new <= 1e-9)) | (ax < l - 1e-6)
        hi = (hi & (y_new >= -1e-9)) | (finite_u & (ax > u + 1e-6))
        y_al = torch.where(lo | hi, y_new, 0.0)
    return best_x if polish_rounds > 0 else x


def fused_admm_solve(a_dense, hess, grad, l, u, rho, *,
                     mus_a0=1e-5, n_scaled=9, n_quad=2, n_hi=2,
                     n_iter=250, polish_rounds=4, sigma=1e-6,
                     alpha_rx=1.6, w_act=1e4, act_tol=1e-4, infty=1e10):
    """Solve B box-constrained QPs  min 0.5 x'Hx + g'x  s.t.  l <= Ax <= u.

    a_dense (M, N): the constraint matrix shared by every system, zero rows
    as padding; hess (B, N, N) with identity on padded variables; grad
    (B, N); l, u, rho (B, M) with padded rows l = u = 0, rho = 1. Returns x
    (B, N). Any B."""
    with span("qct.ops.fused_admm_solve"):
        b = hess.shape[0] if hess.dim() == 3 else None
        _launch.check(a_dense, "a_dense", (M, N))
        _launch.check(hess, "hess", (b, N, N), a_dense.device)
        _launch.check(grad, "grad", (b, N), a_dense.device)
        for name, t in (("l", l), ("u", u), ("rho", rho)):
            _launch.check(t, name, (b, M), a_dense.device)
        NI._check_schedule(n_scaled)
        kw = dict(mus_a0=mus_a0, n_scaled=n_scaled, n_quad=n_quad, n_hi=n_hi,
                  n_iter=n_iter, polish_rounds=polish_rounds, sigma=sigma,
                  alpha_rx=alpha_rx, w_act=w_act, act_tol=act_tol, infty=infty)
        if not hess.is_cuda:
            return fused_admm_solve_reference(a_dense, hess, grad, l, u, rho, **kw)
        a_dense, hess, grad, l, u, rho = map(_launch.aligned, (a_dense, hess, grad, l, u, rho))
        lib = _build.load()
        x = torch.empty_like(grad)
        P = _launch.ptr
        with torch.cuda.device(hess.device):
            rc = lib.qct_fused_admm_solve(
                P(a_dense), P(hess), P(grad), P(l), P(u), P(rho), P(x), b,
                NI._mus_arg(mus_a0, n_scaled), n_scaled, n_quad, n_hi, n_iter,
                polish_rounds, sigma, alpha_rx, w_act, act_tol, infty,
                _launch.stream(hess))
        _launch.raise_on_error(rc, "fused_admm_solve")
        _launch.count(_K5, N)
        return x


_K5 = _launch.new_count(fused_admm_solve)
