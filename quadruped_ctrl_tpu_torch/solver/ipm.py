"""High-accuracy float64 reference QP solver (primal-dual interior point).

The counterpart of `quadruped_ctrl_tpu/solver/ipm.py`: a Mehrotra
predictor-corrector interior-point method with a KKT certificate, the role
qpOASES plays in the reference stack (SURVEY.md section 2.7), here in torch
float64 on the CPU. It is the ground truth the ADMM solver is tested against
and is available for offline verification.
"""

from __future__ import annotations

import torch


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float64, device="cpu")


def _ratio(v: torch.Tensor, dv: torch.Tensor) -> float:
    """The largest step keeping v + a dv >= 0: min over dv < 0 of -v / dv,
    1.0 when no entry decreases."""
    neg = dv < 0
    return float((-v[neg] / dv[neg]).min()) if bool(neg.any()) else 1.0


def solve_qp_exact(hess, grad, a_mat, l, u, iters: int = 100, tol: float = 1e-10):
    """min 0.5 x'Px + q'x  s.t.  l <= Ax <= u, solved to high accuracy in
    float64 by a primal-dual interior-point method over Gx <= h with
    G = [-A; A_finite_upper], h = [-l; u_finite] (rows with u >= 1e9 have no
    upper bound). Arrays or tensors in; x (n,) float64 tensor out. Raises
    AssertionError if the KKT certificate fails."""
    hess, grad, a_mat, l, u = map(_f64, (hess, grad, a_mat, l, u))
    finite_u = u < 1e9
    g_mat = torch.cat([-a_mat, a_mat[finite_u]])
    h_vec = torch.cat([-l, u[finite_u]])
    n = hess.shape[0]
    m = g_mat.shape[0]

    x = torch.zeros(n, dtype=torch.float64)
    s = torch.clamp(h_vec - g_mat @ x, min=1.0)
    z = torch.ones(m, dtype=torch.float64)
    for _ in range(iters):
        r_dual = hess @ x + grad + g_mat.T @ z
        r_pri = g_mat @ x + s - h_vec
        mu = float(s @ z) / m
        if max(float(r_dual.abs().max()), float(r_pri.abs().max()), mu) < tol:
            break
        # predictor-corrector
        w = z / s
        chol = torch.linalg.cholesky(hess + g_mat.T @ (w[:, None] * g_mat))

        def newton(sigma_mu, corr):
            # r_c = S Z e - sigma mu e + corr;  dz = (-r_c - Z ds) / S
            rc_over_s = z - sigma_mu / s + corr / s
            rhs = -r_dual + g_mat.T @ (rc_over_s - w * r_pri)
            dx = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
            ds = -r_pri - g_mat @ dx
            dz = -rc_over_s - w * ds
            return dx, ds, dz

        # affine step for the centering parameter
        dx_a, ds_a, dz_a = newton(0.0, torch.zeros(m, dtype=torch.float64))
        a_p, a_d = min(1.0, _ratio(s, ds_a)), min(1.0, _ratio(z, dz_a))
        mu_aff = float((s + a_p * ds_a) @ (z + a_d * dz_a)) / m
        sigma = (mu_aff / mu) ** 3
        dx, ds, dz = newton(sigma * mu, ds_a * dz_a)
        a_p = min(1.0, 0.99 * _ratio(s, ds))
        a_d = min(1.0, 0.99 * _ratio(z, dz))
        x = x + a_p * dx
        s = s + a_p * ds
        z = z + a_d * dz

    # KKT certificate
    r_dual = float((hess @ x + grad + g_mat.T @ z).abs().max())
    r_pri = max(0.0, float((g_mat @ x - h_vec).max()))
    comp = float(((h_vec - g_mat @ x) * z).abs().max())
    assert r_dual < 1e-6, f"KKT stationarity failed: {r_dual}"
    assert r_pri < 1e-6, f"KKT feasibility failed: {r_pri}"
    assert comp < 1e-5, f"KKT complementarity failed: {comp}"
    return x
