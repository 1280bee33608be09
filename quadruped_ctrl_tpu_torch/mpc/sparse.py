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
`solve_sparse_batch` is `solve_sparse` under `torch.func.vmap`, as
`pipeline.solve_batch` is `solve`. Each solve is a `qct.solve` span, the QP
build a `qct.formation` span inside it (`utils/timer.span`).

Default weights/friction follow the reference's initSparseMPC
(ConvexMPCLocomotion.cpp:732-753): weights [0.25,0.25,10, 2,2,20, 0,0,0.3,
0.2,0.2,0.2], mu=1.0, alpha=4e-5.
"""

from __future__ import annotations

import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import FrameworkConfig
from quadruped_ctrl_tpu_torch.core.types import vmap
from quadruped_ctrl_tpu_torch.mpc import formation
from quadruped_ctrl_tpu_torch.solver import admm
from quadruped_ctrl_tpu_torch.utils.timer import span

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

    # dynamics equalities: x_{k+1} - A x_k - B u_k = g  (x_0 given), built
    # out of place as (h, 12, h, 12) block tensors (the identity on the
    # block diagonal, -A below it; -B on the forces' diagonal) so that
    # `torch.func.vmap` batches the build (`solve_sparse_batch`)
    m_eq = 12 * h
    eye_h = torch.eye(h, dtype=torch.float32, device=dev)
    below = torch.diag(eye_h.new_ones(h - 1), -1)
    eye12 = torch.eye(12, dtype=torch.float32, device=dev)
    a_x = (eye_h[:, None, :, None] * eye12[None, :, None, :]
           - below[:, None, :, None] * a12[None, :, None, :]).reshape(m_eq, nx)
    a_u = -(eye_h[:, None, :, None] * b12[None, :, None, :]).reshape(m_eq, n - nx)
    d = g12.repeat(h)
    d = torch.cat([d[0:12] + a12 @ x0, d[12:]])

    # row-equilibrate the dynamics equalities: the omega rows of B*f_max have
    # entries ~12, which multiplied by the equality rho (1e3) would push the
    # ADMM KKT conditioning past the f32 Newton-Schulz budget
    eq_rows = torch.cat([a_x, a_u], dim=1)
    row_scale = 1.0 / torch.clamp(eq_rows.abs().amax(dim=1), min=1.0)
    d = d * row_scale

    # friction pyramid rows on the normalized forces: one (5,3) block per
    # foot and step, on the block diagonal
    mu_inv = 1.0 / mu
    f_block = _device.constant(
        [[mu_inv, 0, 1], [-mu_inv, 0, 1], [0, mu_inv, 1], [0, -mu_inv, 1], [0, 0, 1]], dev)
    pyr = torch.cat([torch.zeros((20 * h, nx), dtype=torch.float32, device=dev),
                     torch.block_diag(*([f_block] * (h * 4)))], dim=1)
    a_mat = torch.cat([eq_rows * row_scale[:, None], pyr], dim=0)

    # u_hat in [0, gait] on the fz row, the other four rows unbounded above
    u_pyr = torch.cat([torch.full((h, 4, 4), mpc.big_number, dtype=torch.float32, device=dev),
                       inp.gait_table[:h, :, None]], dim=-1)
    l = torch.cat([d, torch.zeros(20 * h, dtype=torch.float32, device=dev)])
    u = torch.cat([d, u_pyr.reshape(-1)])
    return hess, grad, a_mat, l, u


def solve_sparse(cfg: FrameworkConfig, inp, h: int | None = None,
                 weights=None, mu: float | None = None,
                 iterations: int = 150, polish_rounds: int = 6):
    """Solve the stage-wise MPC; returns forces (h,4,3), world frame."""
    h = inp.gait_table.shape[0] if h is None else h
    with span("qct.solve"):
        with span("qct.formation"):
            hess, grad, a_mat, l, u = build_sparse_qp(cfg, inp, h, weights, mu)
        x, _, _ = admm.admm_dense(cfg.solver, hess, grad, a_mat, l, u,
                                  iterations=iterations,
                                  polish_rounds=polish_rounds)
        u_hat = x[12 * h:]
        return (u_hat * cfg.mpc.f_max).reshape(h, 4, 3)


def solve_sparse_batch(cfg: FrameworkConfig, inputs, **kw):
    """`solve_sparse` vmapped over the leading batch axis of `inputs` (a
    pipeline.MPCInputs): forces (B, h, 4, 3)."""
    return vmap(lambda i: solve_sparse(cfg, i, **kw))(inputs)
