"""Plain reference of the condensed convex-MPC QP of the Mini Cheetah.

Written from the reference controller's equations (SolverMPC.cpp:235-254 the
single-rigid-body model, :87-125 the prediction stacking, :335-399 the cost,
:352-377 the friction pyramid and force bounds), in plain PyTorch, batched
over scenarios, on whatever device the inputs lie on:

* the continuous SRB model and its exact zero-order-hold discretization by
  the matrix exponential of dt [[A, B], [0, 0]];
* the condensed prediction X = A_qp x0 + B_qp U, built by the power chain;
* the cost J(U) = sum_k |x_k - x_ref,k|^2_Q + alpha |U|^2 (Q the 12 state
  weights, 0 on the gravity state), as H = 2 (B_qp' Q B_qp + alpha I) and
  g = 2 B_qp' Q (A_qp x0 - X_ref);
* the constraints of each foot and step: |fx| <= mu fz, |fy| <= mu fz,
  0 <= fz <= f_max for a stance foot, every force 0 for a swing foot;
* a primal-dual interior-point method (Mehrotra predictor-corrector) on the
  stance forces, the swing forces held at 0.

It imports nothing of the measured program and takes nothing it made: it
reads the configuration's constants and the raw scenario inputs.

`precision="float64"` is the reference. `precision="tf32"` is the control:
every quantity in float32 and every operand of a matrix product rounded to
TF32 (10 mantissa bits) first, which is what a product on the tensor cores
in TF32 computes, on any device.
"""

from __future__ import annotations

import torch

FIELDS = ("rpy", "position", "omega_world", "v_world", "r_feet", "traj",
          "gait_table", "x_drag")

# each stance foot's rows G f >= d: mu fz +- fx >= 0, mu fz +- fy >= 0,
# fz >= 0, -fz >= -f_max (mu and f_max filled in per configuration)
_ROWS = 6


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (ties to even)."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class Reference:
    """The QP of one configuration, in one precision."""

    def __init__(self, mpc: dict, precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}: float64 or tf32")
        self.mpc = mpc
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        self.dt = float(mpc["dt"]) * int(mpc["iterations_between_mpc"])

    # -- products -----------------------------------------------------------
    def mm(self, a, b):
        if self.tf32:
            return tf32_round(a) @ tf32_round(b)
        return a @ b

    def mv(self, a, v):
        return self.mm(a, v[..., None])[..., 0]

    # -- model ----------------------------------------------------------------
    def srb(self, r_feet, yaw, x_drag):
        """Continuous A (S,13,13) and B (S,13,12) (SolverMPC.cpp:235-254)."""
        s_, dt_, dev = yaw.shape[0], self.dtype, yaw.device
        c, s = torch.cos(yaw), torch.sin(yaw)
        r_yaw = torch.zeros((s_, 3, 3), dtype=dt_, device=dev)
        r_yaw[:, 0, 0], r_yaw[:, 0, 1] = c, -s
        r_yaw[:, 1, 0], r_yaw[:, 1, 1] = s, c
        r_yaw[:, 2, 2] = 1.0
        i_body = torch.diag(torch.tensor(self.mpc["inertia"], dtype=dt_, device=dev))
        i_world = self.mm(self.mm(r_yaw, i_body.expand(s_, 3, 3)), r_yaw.transpose(1, 2))
        i_inv = torch.linalg.inv(i_world)
        a = torch.zeros((s_, 13, 13), dtype=dt_, device=dev)
        a[:, 3, 9] = a[:, 4, 10] = a[:, 5, 11] = 1.0
        a[:, 11, 9] = x_drag
        a[:, 11, 12] = 1.0
        a[:, 0:3, 6:9] = r_yaw.transpose(1, 2)
        b = torch.zeros((s_, 13, 12), dtype=dt_, device=dev)
        rx, ry, rz = r_feet[..., 0], r_feet[..., 1], r_feet[..., 2]
        for f in range(4):
            cross = torch.zeros((s_, 3, 3), dtype=dt_, device=dev)
            cross[:, 0, 1], cross[:, 0, 2] = -rz[:, f], ry[:, f]
            cross[:, 1, 0], cross[:, 1, 2] = rz[:, f], -rx[:, f]
            cross[:, 2, 0], cross[:, 2, 1] = -ry[:, f], rx[:, f]
            b[:, 6:9, 3 * f:3 * f + 3] = self.mm(i_inv, cross)
            b[:, 9:12, 3 * f:3 * f + 3] = torch.eye(3, dtype=dt_, device=dev) / self.mpc["mass"]
        return a, b

    def discrete(self, a, b):
        """Exact zero-order hold: expm(dt [[A, B], [0, 0]])."""
        s_ = a.shape[0]
        m = torch.zeros((s_, 25, 25), dtype=self.dtype, device=a.device)
        m[:, :13, :13] = a
        m[:, :13, 13:] = b
        e = torch.linalg.matrix_exp(m * self.dt)
        return e[:, :13, :13], e[:, :13, 13:]

    def x0(self, inp):
        g = torch.full_like(inp["rpy"][:, :1], -float(self.mpc["gravity"]))
        return torch.cat([inp["rpy"], inp["position"], inp["omega_world"],
                          inp["v_world"], g], dim=1)

    def prediction(self, ad, bd, h):
        """A_qp (S,h,13,13) = Ad^(k+1); B_qp (S,13h,12h), block (k,j) =
        Ad^(k-j) Bd for k >= j (SolverMPC.cpp:103-120)."""
        s_ = ad.shape[0]
        powers_b = [bd]
        a_pow = [ad]
        for _ in range(1, h):
            powers_b.append(self.mm(ad, powers_b[-1]))
            a_pow.append(self.mm(ad, a_pow[-1]))
        bqp = torch.zeros((s_, h, 13, h, 12), dtype=self.dtype, device=ad.device)
        for k in range(h):
            for j in range(k + 1):
                bqp[:, k, :, j, :] = powers_b[k - j]
        return torch.stack(a_pow, dim=1), bqp.reshape(s_, 13 * h, 12 * h)

    def qp(self, inp):
        """(H (S,12h,12h), g (S,12h), const (S,), aux) of the condensed
        cost, J(U) = U'HU/2 + g'U + const."""
        inp = {k: inp[k].to(self.dtype) for k in FIELDS}
        h = inp["traj"].shape[1]
        a, b = self.srb(inp["r_feet"], inp["rpy"][:, 2], inp["x_drag"])
        ad, bd = self.discrete(a, b)
        aqp, bqp = self.prediction(ad, bd, h)
        x0 = self.x0(inp)
        free = torch.einsum("skij,sj->ski", aqp, x0)                   # (S,h,13)
        q = torch.tensor(list(self.mpc["weights"]) + [0.0], dtype=self.dtype,
                         device=x0.device)
        resid = (free - inp["traj"]).reshape(x0.shape[0], 13 * h)
        qvec = q.repeat(h)
        qb = bqp * qvec[None, :, None]
        n = 12 * h
        hess = 2.0 * (self.mm(bqp.transpose(1, 2), qb)
                      + float(self.mpc["alpha"]) * torch.eye(n, dtype=self.dtype,
                                                             device=x0.device))
        grad = 2.0 * self.mv(qb.transpose(1, 2), resid)
        const = (resid * resid * qvec).sum(1)
        return hess, grad, const, dict(bqp=bqp, resid=resid, qvec=qvec)

    def cost(self, inp, forces):
        """J of forces (S,h,4,3) by the prediction itself (no H): the
        tracking error of the predicted states plus alpha |U|^2."""
        _, _, _, aux = self.qp(inp)
        u = forces.reshape(forces.shape[0], -1).to(self.dtype)
        err = aux["resid"] + self.mv(aux["bqp"], u)
        return (err * err * aux["qvec"]).sum(1) + float(self.mpc["alpha"]) * (u * u).sum(1)

    # -- solve -----------------------------------------------------------------
    def _rows(self, dev):
        mu, fmax = float(self.mpc["mu"]), float(self.mpc["f_max"])
        g = torch.tensor([[1.0, 0.0, mu], [-1.0, 0.0, mu], [0.0, 1.0, mu],
                          [0.0, -1.0, mu], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]],
                         dtype=self.dtype, device=dev)
        d = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, -fmax], dtype=self.dtype, device=dev)
        return g, d

    def solve(self, inp, iterations: int = 80):
        """Optimal forces (S,h,4,3) by a primal-dual interior-point method,
        and the largest final residuals (a dict) to show that it converged.
        Forces are scaled by f_max inside, so all is O(1)."""
        hess, grad, _, _ = self.qp(inp)
        s_, n = grad.shape
        h = n // 12
        dev = grad.device
        fmax = float(self.mpc["f_max"])
        stance = inp["gait_table"].to(self.dtype).reshape(s_, h * 4) > 0.5     # (S,hf)
        var = stance.repeat_interleave(3, dim=1)                               # (S,n)
        # swing forces are 0: their rows and columns become the identity
        keep = (var[:, :, None] & var[:, None, :]).to(self.dtype)
        hn = hess * keep * fmax * fmax + torch.diag_embed((~var).to(self.dtype))
        gn = grad * var.to(self.dtype) * fmax
        gmat, d = self._rows(dev)
        d = d / fmax
        rmask = stance[:, :, None].to(self.dtype).expand(s_, h * 4, _ROWS)     # (S,hf,6)

        def c_of(x):                    # (S,n) -> (S,hf,6)
            return torch.einsum("rk,sfk->sfr", gmat, x.reshape(s_, h * 4, 3))

        def ct_of(y):                   # (S,hf,6) -> (S,n)
            return torch.einsum("rk,sfr->sfk", gmat, y).reshape(s_, n)

        x = torch.zeros((s_, n), dtype=self.dtype, device=dev)
        sl = torch.clamp(c_of(x) - d, min=1.0)
        z = torch.ones_like(sl)
        m_rows = rmask.sum((1, 2)).clamp(min=1.0)
        tol = 1e-6 if self.tf32 else 1e-11
        gscale = 1.0 + gn.abs().amax(1)
        for _ in range(iterations):
            zm, sm = z * rmask, torch.where(rmask > 0, sl, torch.ones_like(sl))
            r_d = self.mv(hn, x) + gn - ct_of(zm)
            r_p = (c_of(x) - sl - d) * rmask
            mu_gap = (sm * zm).sum((1, 2)) / m_rows
            w = zm / sm                                                       # (S,hf,6)
            blocks = torch.einsum("rk,sfr,rl->sfkl", gmat, w, gmat)          # (S,hf,3,3)
            kkt = hn.clone()
            idx = torch.arange(h * 4, device=dev)
            kv = kkt.reshape(s_, h * 4, 3, h * 4, 3)
            kv[:, idx, :, idx, :] += blocks.transpose(0, 1)
            chol, info = torch.linalg.cholesky_ex(kkt)
            # near the end the barrier weights reach ~1e12, and a scenario
            # whose factorization rounding breaks stops where it is; the
            # control, in float32, gets a little more of the diagonal instead
            for boost in ((1e-6, 1e-4, 1e-2) if self.tf32 else ()):
                if not bool((info > 0).any()):
                    break
                diag = kkt.diagonal(dim1=1, dim2=2)
                chol2, info2 = torch.linalg.cholesky_ex(kkt + torch.diag_embed(boost * diag))
                bad = info > 0
                chol = torch.where(bad[:, None, None], chol2, chol)
                info = torch.where(bad, info2, info)

            def newton(r_c):
                rhs = -r_d - ct_of((r_c + zm * r_p) / sm)
                dx = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
                ds = (c_of(dx) + r_p) * rmask
                dz = -(r_c + zm * ds) / sm * rmask
                return dx, ds, dz

            def step_len(v, dv):
                ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
                ratio = torch.where(rmask > 0, ratio, torch.full_like(v, float("inf")))
                return torch.clamp(ratio.amin((1, 2)), max=1.0)

            dx, ds, dz = newton(sm * zm)
            a_aff = torch.minimum(step_len(sm, ds), step_len(zm, dz))
            mu_aff = (((sm + a_aff[:, None, None] * ds) * (zm + a_aff[:, None, None] * dz)
                       * rmask).sum((1, 2)) / m_rows)
            sigma = (mu_aff / mu_gap.clamp(min=1e-300)).clamp(0.0, 1.0) ** 3
            r_c = sm * zm + ds * dz - (sigma * mu_gap)[:, None, None] * rmask
            dx, ds, dz = newton(r_c)
            alpha = 0.99 * torch.minimum(step_len(sm, ds), step_len(zm, dz))
            # a converged scenario stops: s and z would underflow to 0
            done = ((mu_gap < tol) & (r_d.abs().amax(1) < tol * gscale)) | (info > 0)
            if bool(done.all()):
                break
            alpha = torch.clamp(alpha, max=1.0)[:, None]
            go = ~done[:, None]
            x = torch.where(go, x + alpha * dx, x)
            upd = (rmask > 0) & go[:, :, None]
            sl = torch.where(upd, sm + alpha[:, :, None] * ds, sl)
            z = torch.where(upd, zm + alpha[:, :, None] * dz, z)
        zm = z * rmask
        res = dict(
            dual=float((self.mv(hn, x) + gn - ct_of(zm)).abs().max()),
            primal=float(((c_of(x) - d).clamp(max=0.0) * rmask).abs().max()) * fmax,
            gap=float(((sl * zm).sum((1, 2)) / m_rows).max()))
        forces = (x * var.to(self.dtype) * fmax).reshape(s_, h, 4, 3)
        return forces, res


def violation(mpc: dict, forces: torch.Tensor, gait_table: torch.Tensor) -> torch.Tensor:
    """Largest constraint violation of each scenario's forces, in N:
    |fx| - mu fz, |fy| - mu fz, -fz and fz - f_max on stance feet, |f| on
    swing feet. forces (S,h,4,3), gait_table (S,h,4) -> (S,)."""
    f = forces.to(torch.float64)
    mu, fmax = float(mpc["mu"]), float(mpc["f_max"])
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    on = torch.stack([fx.abs() - mu * fz, fy.abs() - mu * fz, -fz, fz - fmax], -1).amax(-1)
    off = f.abs().amax(-1)
    stance = gait_table.to(torch.float64) > 0.5
    per = torch.where(stance, on, off).clamp(min=0.0)
    return per.flatten(1).amax(1)
