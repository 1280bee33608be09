"""Stage-wise ("sparse") MPC formulation — the SparseCMPC-equivalent path.

The counterpart of `quadruped_ctrl_tpu/mpc/sparse.py`. The reference carries
a second MPC formulation (src/MPC_Ctrl/SparseCMPC.cpp, SparseCMPC_Math.cpp,
OsqpTriples.cpp; switched off by cmpc_use_sparse=0 at
ConvexMPCLocomotion.cpp:581-587): 12 states per step (gravity moved to the
affine term), states AND forces as decision variables, dynamics as equality
constraints. Its niche is long horizons where the condensed form's O(h^2)
workspace explodes.

Here, as in the JAX package: the same stage-wise QP with variables
z = [x_1..x_h (12h), u_0..u_{h-1} (12h)] (force part normalized by f_max),
dynamics equalities enforced through the generic ADMM's equality-row
handling (rho * rho_equality_scale), friction pyramid on the forces, solved
by `solver/admm.admm_dense` in plain PyTorch where the inputs lie (no
kernel, as the JAX package runs no Pallas kernel here). The per-step
(A, B, affine) come from the SAME exact nilpotent discretization as the dense
path, with the gravity column folded into the affine term.

Default weights/friction follow the reference's initSparseMPC
(ConvexMPCLocomotion.cpp:732-753): weights [0.25,0.25,10, 2,2,20, 0,0,0.3,
0.2,0.2,0.2], mu=1.0, alpha=4e-5.
"""

from __future__ import annotations

import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import FrameworkConfig
from quadruped_ctrl_tpu_torch.mpc import formation
from quadruped_ctrl_tpu_torch.solver import admm

SPARSE_WEIGHTS = (0.25, 0.25, 10.0, 2.0, 2.0, 20.0, 0.0, 0.0, 0.3, 0.2, 0.2, 0.2)
SPARSE_MU = 1.0


def build_sparse_qp(cfg: FrameworkConfig, inp, h: int,
                    weights=None, mu: float | None = None):
    """Assemble (hess, grad, a_mat, l, u) for the stage-wise QP.

    inp: one scenario's pipeline.MPCInputs (no batch axis). Variables:
    [X (12h); U_hat (12h)] with u = f_max * u_hat. Returns dense constraint
    data for admm_dense.
    """
    mpc = cfg.mpc
    dev = inp.rpy.device
    w12 = _device.constant(weights if weights is not None else SPARSE_WEIGHTS, dev)
    mu = SPARSE_MU if mu is None else mu
    f = mpc.f_max

    a_ct, b_ct = formation.srb_ct_dynamics(mpc, inp.r_feet, inp.rpy[2], inp.x_drag)
    adt13, bdt13 = formation.discretize(a_ct, b_ct, cfg.dt_mpc)
    a12 = adt13[0:12, 0:12]
    b12 = bdt13[0:12, :] * f                 # normalized forces
    g12 = adt13[0:12, 12] * (-mpc.gravity)   # gravity affine term

    x0 = formation.build_x0(inp.rpy, inp.position, inp.omega_world,
                            inp.v_world, mpc.gravity)[0:12]

    n = 24 * h
    nx = 12 * h

    # cost: states tracked to the reference; forces regularized
    w_rep = w12.repeat(h)
    hess = torch.diag(torch.cat([2.0 * w_rep, w_rep.new_full((n - nx,),
                                                              2.0 * mpc.alpha * f * f)]))
    x_ref = inp.traj[:h, 0:12].reshape(-1)
    grad = torch.cat([-2.0 * w_rep * x_ref, w_rep.new_zeros(nx)])

    # dynamics equalities: x_{k+1} - A x_k - B u_k = g  (x_0 given)
    m_eq = 12 * h
    a_mat = torch.zeros((m_eq + 20 * h, n), dtype=torch.float32, device=dev)
    eye12 = torch.eye(12, dtype=torch.float32, device=dev)
    for k in range(h):
        r0 = 12 * k
        a_mat[r0:r0 + 12, 12 * k:12 * k + 12] = eye12
        if k > 0:
            a_mat[r0:r0 + 12, 12 * (k - 1):12 * k] = -a12
        a_mat[r0:r0 + 12, nx + 12 * k:nx + 12 * (k + 1)] = -b12
    d = g12.repeat(h)
    d = torch.cat([d[0:12] + a12 @ x0, d[12:]])

    # row-equilibrate the dynamics equalities: the omega rows of B*f_max have
    # entries ~12, which multiplied by the equality rho (1e3) would push the
    # ADMM KKT conditioning past the f32 Newton-Schulz budget
    eq_rows = a_mat[0:m_eq, :]
    row_scale = 1.0 / torch.clamp(eq_rows.abs().amax(dim=1), min=1.0)
    a_mat[0:m_eq, :] = eq_rows * row_scale[:, None]
    d = d * row_scale

    # friction pyramid rows on the normalized forces: one (5,3) block per
    # foot and step, on the block diagonal
    mu_inv = 1.0 / mu
    f_block = _device.constant(
        [[mu_inv, 0, 1], [-mu_inv, 0, 1], [0, mu_inv, 1], [0, -mu_inv, 1], [0, 0, 1]], dev)
    a_mat[m_eq:, nx:] = torch.block_diag(*([f_block] * (h * 4)))

    u_pyr = torch.full((h, 4, 5), mpc.big_number, dtype=torch.float32, device=dev)
    u_pyr[:, :, 4] = inp.gait_table[:h]      # u_hat in [0, gait]
    l = torch.cat([d, torch.zeros(20 * h, dtype=torch.float32, device=dev)])
    u = torch.cat([d, u_pyr.reshape(-1)])
    return hess, grad, a_mat, l, u


def solve_sparse(cfg: FrameworkConfig, inp, h: int | None = None,
                 weights=None, mu: float | None = None,
                 iterations: int = 150, polish_rounds: int = 6):
    """Solve the stage-wise MPC; returns forces (h,4,3), world frame."""
    h = inp.gait_table.shape[0] if h is None else h
    hess, grad, a_mat, l, u = build_sparse_qp(cfg, inp, h, weights, mu)
    x, _, _ = admm.admm_dense(cfg.solver, hess, grad, a_mat, l, u,
                              iterations=iterations,
                              polish_rounds=polish_rounds)
    u_hat = x[12 * h:]
    return (u_hat * cfg.mpc.f_max).reshape(h, 4, 3)
