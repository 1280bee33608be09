"""Condensed convex-MPC formation.

The counterpart of `quadruped_ctrl_tpu/mpc/formation.py` (same names, same
layouts):

* batched over leading dimensions, for the packed solve: the friction
  pyramid applied structurally, the closed-form SRB discretization, the
  sortless stance selection, the stance-compressed QP cost and its packed
  form;
* per scenario, for `pipeline.solve` and `solve_compressed` (and batched by
  `torch.func.vmap` there): the continuous SRB dynamics, their exact
  discretization, the prediction stacking and the condensed QP costs, full
  and stance-compressed. These build every array out of place (no
  `.at[].set` counterpart), so that vmap batches them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from quadruped_ctrl_tpu_torch.config import MPCConfig
from quadruped_ctrl_tpu_torch import device


def _weights(cfg_mpc: MPCConfig, like: torch.Tensor) -> torch.Tensor:
    """The 12 state weights plus a zero for the gravity state, (13,)."""
    w = np.concatenate([cfg_mpc.weights_arr(), np.zeros(1, np.float32)])
    return torch.as_tensor(w, dtype=like.dtype, device=like.device)


def pyramid_bounds(cfg_mpc: MPCConfig, gait_table):
    """Bounds of the 5 pyramid rows per foot-step. gait_table (..., h, nf)
    in {0,1} -> l, u (..., h, nf, 5)."""
    shape = gait_table.shape + (5,)
    big = torch.full(gait_table.shape + (4,), cfg_mpc.big_number, dtype=gait_table.dtype,
                     device=gait_table.device)
    u = torch.cat([big, (gait_table * cfg_mpc.f_max)[..., None]], dim=-1)
    l = torch.zeros(shape, dtype=gait_table.dtype, device=gait_table.device)
    return l, u


def pyramid_apply(cfg_mpc: MPCConfig, x):
    """A @ x for the friction pyramid. x (..., 3) forces -> (..., 5)."""
    mu_inv = 1.0 / cfg_mpc.mu
    fx, fy, fz = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack(
        [mu_inv * fx + fz, -mu_inv * fx + fz, mu_inv * fy + fz,
         -mu_inv * fy + fz, fz], dim=-1)


def pyramid_apply_t(cfg_mpc: MPCConfig, y):
    """A' @ y. y (..., 5) -> (..., 3)."""
    mu_inv = 1.0 / cfg_mpc.mu
    fx = mu_inv * (y[..., 0] - y[..., 1])
    fy = mu_inv * (y[..., 2] - y[..., 3])
    fz = y[..., 0] + y[..., 1] + y[..., 2] + y[..., 3] + y[..., 4]
    return torch.stack([fx, fy, fz], dim=-1)


def pyramid_gram(cfg_mpc: MPCConfig, rho):
    """A' diag(rho) A per foot-step block. rho (..., 5) -> (..., 3, 3)."""
    mu_inv = 1.0 / cfg_mpc.mu
    r0, r1, r2, r3, r4 = (rho[..., i] for i in range(5))
    gxx = mu_inv * mu_inv * (r0 + r1)
    gyy = mu_inv * mu_inv * (r2 + r3)
    gzz = r0 + r1 + r2 + r3 + r4
    gxz = mu_inv * (r0 - r1)
    gyz = mu_inv * (r2 - r3)
    zeros = torch.zeros_like(gxx)
    g = torch.stack([gxx, zeros, gxz, zeros, gyy, gyz, gxz, gyz, gzz], dim=-1)
    return g.reshape(rho.shape[:-1] + (3, 3))


def build_x0(rpy, position, omega_world, v_world, gravity: float):
    """Initial condensed-MPC state (..., 13)."""
    g = torch.full(rpy.shape[:-1] + (1,), -gravity, dtype=rpy.dtype,
                   device=rpy.device)
    return torch.cat([rpy, position, omega_world, v_world, g], dim=-1)


def srb_discrete(cfg_mpc: MPCConfig, r_feet, yaw, x_drag, dt: float):
    """Closed-form discrete SRB dynamics (Adt (..., 13, 13), Bdt (..., 13, 12)):
    Adt = I + dt A + dt^2/2 A^2, Bdt = (dt I + dt^2/2 A + dt^3/6 A^2) B with
    the SRB A nilpotent of index 3, batched over leading dims."""
    dtype, dev = r_feet.dtype, r_feet.device
    lead = r_feet.shape[:-2]
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    ryaw_t = torch.stack([
        torch.stack([c, s, zero], dim=-1),
        torch.stack([-s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)                                                # (...,3,3)

    ix, iy, iz = (float(v) for v in cfg_mpc.inertia)
    a_, b_ = 1.0 / ix, 1.0 / iy
    iinv = torch.stack([
        torch.stack([a_ * c * c + b_ * s * s, (a_ - b_) * c * s, zero], dim=-1),
        torch.stack([(a_ - b_) * c * s, a_ * s * s + b_ * c * c, zero], dim=-1),
        torch.stack([zero, zero, one / iz], dim=-1),
    ], dim=-2)                                                # (...,3,3)

    rx_, ry_, rz_ = r_feet[..., 0], r_feet[..., 1], r_feet[..., 2]
    zf = torch.zeros_like(rx_)
    rx = torch.stack([
        torch.stack([zf, -rz_, ry_], dim=-1),
        torch.stack([rz_, zf, -rx_], dim=-1),
        torch.stack([-ry_, rx_, zf], dim=-1),
    ], dim=-2)                                                # (...,4,3,3)
    tb = torch.einsum("...ij,...fjk->...fik", iinv, rx)
    tb_flat = tb.transpose(-3, -2).reshape(lead + (3, 12))

    m = cfg_mpc.mass
    base = np.eye(13, dtype=np.float32)
    base[3, 9] = base[4, 10] = base[5, 11] = dt
    base[11, 12] = dt
    base[5, 12] = 0.5 * dt * dt
    xd_mask = np.zeros((13, 13), dtype=np.float32)
    xd_mask[11, 9] = dt
    xd_mask[5, 9] = 0.5 * dt * dt
    adt = (torch.as_tensor(base, dtype=dtype, device=dev)
           + F.pad(dt * ryaw_t, (6, 4, 0, 10))
           + x_drag[..., None, None] * torch.as_tensor(xd_mask, dtype=dtype,
                                                       device=dev))

    eye3x4 = torch.as_tensor(np.tile(np.eye(3, dtype=np.float32), (1, 4)),
                             dtype=dtype, device=dev)         # (3,12)
    xsel = eye3x4[0]                                          # fx columns
    r03 = (0.5 * dt * dt) * torch.einsum("...ij,...jk->...ik", ryaw_t, tb_flat)
    s35 = (0.5 * dt * dt / m) * eye3x4
    row5 = s35[2].expand(lead + (12,)) \
        + (dt**3 / 6.0 / m) * x_drag[..., None] * xsel
    r35 = torch.stack([s35[0].expand(lead + (12,)),
                       s35[1].expand(lead + (12,)), row5], dim=-2)
    r69 = dt * tb_flat
    s912 = (dt / m) * eye3x4
    row11 = s912[2].expand(lead + (12,)) \
        + (0.5 * dt * dt / m) * x_drag[..., None] * xsel
    r912 = torch.stack([s912[0].expand(lead + (12,)),
                        s912[1].expand(lead + (12,)), row11], dim=-2)
    r12 = torch.zeros(lead + (1, 12), dtype=dtype, device=dev)
    bdt = torch.cat([r03, r35, r69, r912, r12], dim=-2)
    return adt, bdt


def stance_selectors(gait_table, max_stance: int):
    """Sortless stance compression, batched over leading dims: stance feet
    first, in foot order. Returns (foot_idx int32 (..., h, ms),
    gait_red (..., h, ms), sel (..., h, ms, 4)) with sel the one-hot
    selection `qp_cost_compressed_nil_sel` consumes."""
    g = gait_table
    dtype = g.dtype
    f = torch.arange(4, dtype=dtype, device=g.device)
    key = (1.0 - g) * 4.0 + f                                 # (...,h,4)
    rank = (key[..., :, None] > key[..., None, :]).sum(-1)    # (...,h,4)
    oh = F.one_hot(rank, 4).to(dtype)                         # (...,h,4,slot)
    sel = oh.transpose(-1, -2)[..., :max_stance, :]           # (...,h,ms,4)
    foot_idx = torch.einsum("...sf,f->...s", sel, f).to(torch.int32)
    gait_red = torch.einsum("...sf,...f->...s", sel, g)
    return foot_idx, gait_red, sel


def _phi_polys(h: int, dtype=torch.float32, device=None):
    """Toeplitz weights Phi_m[x, c] = phi_m(x - c) (x >= c) of the power
    family Adt^k = I + k N + C(k,2) N^2, (3, h, h)."""
    x = torch.arange(h, dtype=dtype, device=device)[:, None]
    c = torch.arange(h, dtype=dtype, device=device)[None, :]
    k = x - c
    tri = (k >= 0).to(dtype)
    return torch.stack([tri, k * tri, 0.5 * k * (k - 1.0) * tri])


def _nil_family(adt, bdt):
    """(N, N^2, [Bdt, N Bdt, N^2 Bdt] (..., 3, 13, 12)) with N = Adt - I."""
    eye13 = torch.eye(13, dtype=adt.dtype, device=adt.device)
    n1 = adt - eye13
    n2 = torch.einsum("...ij,...jk->...ik", n1, n1)
    bfam = torch.stack([bdt, torch.einsum("...ij,...jk->...ik", n1, bdt),
                        torch.einsum("...ij,...jk->...ik", n2, bdt)], dim=-3)
    return n1, n2, bfam


def _weighted_residual(n1, n2, x0, x_d, sqrt_mask, sqrt_w):
    """(A^k x0 - x_d) * sqrt(step_mask) * sqrt(w), (..., h, 13)."""
    h = x_d.shape[-2]
    nx0 = torch.einsum("...ij,...j->...i", n1, x0)
    n2x0 = torch.einsum("...ij,...j->...i", n2, x0)
    k = torch.arange(1, h + 1, dtype=x0.dtype, device=x0.device)[:, None]
    ax0 = (x0[..., None, :] + k * nx0[..., None, :]
           + (0.5 * k * (k - 1.0)) * n2x0[..., None, :])
    return (ax0 - x_d) * (sqrt_mask[..., :, None] * sqrt_w)


def qp_cost_compressed_nil_sel(cfg_mpc: MPCConfig, adt, bdt, x0, x_d,
                               step_mask, sel):
    """Stance-compressed condensed QP cost with the selection passed
    directly, batched over leading dims. Returns (hess (..., n_c, n_c),
    grad (..., n_c)), n_c = 3 ms h."""
    dtype, dev = adt.dtype, adt.device
    lead = x_d.shape[:-2]
    h = x_d.shape[-2]
    ms = sel.shape[-2]
    n_c = h * ms * 3
    n1, n2, bfam = _nil_family(adt, bdt)
    sqrt_w = torch.sqrt(_weights(cfg_mpc, adt))
    sqrt_mask = torch.sqrt(step_mask)                         # (...,h)
    bfam_s = bfam * sqrt_w[:, None]                           # scale p rows
    u = torch.einsum("...mpfz,...cjf->...mpcjz",
                     bfam_s.reshape(lead + (3, 13, 4, 3)), sel
                     ).reshape(lead + (3, 13, n_c))
    phi = _phi_polys(h, dtype, dev)                           # (3,h,h)
    phiexp = torch.repeat_interleave(phi, ms * 3, dim=-1)     # (3,h,n_c)
    bq = (phiexp[:, :, None, :] * u[..., :, None, :, :]).sum(-4)
    bq = (bq * sqrt_mask[..., :, None, None]).reshape(lead + (h * 13, n_c))
    hess = 2.0 * (torch.einsum("...kc,...kd->...cd", bq, bq)
                  + cfg_mpc.alpha * torch.eye(n_c, dtype=dtype, device=dev))
    resid = _weighted_residual(n1, n2, x0, x_d, sqrt_mask, sqrt_w)
    grad = 2.0 * torch.einsum("...kc,...k->...c", bq,
                              resid.reshape(lead + (h * 13,)))
    return hess, grad


def packed_qp_operands(cfg_mpc: MPCConfig, adt, bdt, x0, x_d, step_mask, sel):
    """Per-scenario operands of the packed formation kernel
    (ops/formation_pack.py): bfam_s (B,3,13,12), smat (B,12,n_c),
    r (B,13h), smask (B,h)."""
    dtype, dev = adt.dtype, adt.device
    b = x_d.shape[0]
    h = x_d.shape[-2]
    ms = sel.shape[-2]
    n_c = h * ms * 3
    n1, n2, bfam = _nil_family(adt, bdt)
    sqrt_w = torch.sqrt(_weights(cfg_mpc, adt))
    bfam_s = bfam * sqrt_w[:, None]
    # smat[(f,z),(c,j,z')] = sel[c,j,f] * (z==z'): (B,4,h,ms) x I3
    sel_t = torch.movedim(sel, -1, -3)                        # (B,4,h,ms)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    smat = (sel_t[:, :, None, :, :, None] * eye3[None, :, None, None, :]
            ).reshape(b, 12, n_c)
    smask = torch.sqrt(step_mask)
    r = _weighted_residual(n1, n2, x0, x_d, smask, sqrt_w).reshape(b, h * 13)
    return (bfam_s.contiguous(), smat.contiguous(), r.contiguous(),
            smask.contiguous())


def qp_cost_packed(cfg_mpc: MPCConfig, adt, bdt, x0, x_d, step_mask, sel,
                   pack: int, use_kernels: bool | None = None):
    """Block-diagonally packed QP cost, `pack` scenarios per system. Returns
    (hess (B/pack, pack n_c, pack n_c), grad (B/pack, pack n_c)), the layout
    `admm.admm_mpc_batched(..., pack=pack)` consumes. The kernel branch runs
    kernel K1 (ops/formation_pack.form_packed); the plain branch is
    `qp_cost_compressed_nil_sel` plus the block-diagonal embedding."""
    use_kernels = device.use_kernels(adt, use_kernels)
    b = x_d.shape[0]
    h = x_d.shape[-2]
    ms = sel.shape[-2]
    n_c = h * ms * 3
    if b % pack:
        raise ValueError(f"batch {b} is not a multiple of pack={pack}")
    if pack * n_c > 256:
        # beyond the kernel's 256 tile (e.g. pack=4 at h=16): the
        # block-diagonal embedding handles any pack size
        use_kernels = False
    if use_kernels:
        from quadruped_ctrl_tpu_torch.ops import formation_pack as FP

        bfam_s, smat, r, smask = packed_qp_operands(
            cfg_mpc, adt, bdt, x0, x_d, step_mask, sel)
        return FP.form_packed(bfam_s, smat, r, smask, h, ms, pack,
                              float(cfg_mpc.alpha))
    hess, grad = qp_cost_compressed_nil_sel(cfg_mpc, adt, bdt, x0, x_d,
                                            step_mask, sel)
    hp = hess.reshape(b // pack, pack, n_c, n_c)
    kp = torch.zeros((b // pack, pack * n_c, pack * n_c), dtype=hess.dtype,
                     device=hess.device)
    for j in range(pack):
        kp[:, j * n_c:(j + 1) * n_c, j * n_c:(j + 1) * n_c] = hp[:, j]
    return kp, grad.reshape(b // pack, pack * n_c)


def scatter_forces(x_red, foot_idx, h: int):
    """Reduced solution (..., h*ms*3) -> full (..., h, 4, 3) with zeros on
    swing feet, batched over leading dims."""
    lead = foot_idx.shape[:-2]
    ms = foot_idx.shape[-1]
    src = x_red.reshape(lead + (h, ms, 3))
    index = foot_idx.long()[..., None].expand(lead + (h, ms, 3))
    forces = torch.zeros(lead + (h, 4, 3), dtype=x_red.dtype, device=x_red.device)
    return forces.scatter(-2, index, src)


# ---------------------------------------------------------------------------
# Per-scenario formation (pipeline.solve / solve_compressed).

def _skew_feet(r_feet):
    """(4, 3) foot positions -> (4, 3, 3) cross-product matrices [r]x."""
    rx_, ry_, rz_ = r_feet[..., 0], r_feet[..., 1], r_feet[..., 2]
    zf = torch.zeros_like(rx_)
    return torch.stack([
        torch.stack([zf, -rz_, ry_], dim=-1),
        torch.stack([rz_, zf, -rx_], dim=-1),
        torch.stack([-ry_, rx_, zf], dim=-1),
    ], dim=-2)


def srb_ct_dynamics(cfg_mpc: MPCConfig, r_feet, yaw, x_drag):
    """Continuous-time A (13, 13), B (13, 12) of the single rigid body
    (SolverMPC.cpp:235-254). r_feet (4, 3): foot positions relative to the
    CoM, world frame. I_world^-1 is a 3 x 3 `torch.linalg.inv`, as the JAX
    function's `jnp.linalg.inv`."""
    dtype, dev = r_feet.dtype, r_feet.device
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    r_yaw = torch.stack([torch.stack([c, -s, zero]), torch.stack([s, c, zero]),
                         torch.stack([zero, zero, one])]).to(dtype)
    i_body = torch.as_tensor(cfg_mpc.inertia_arr(), dtype=dtype, device=dev)
    i_inv = torch.linalg.inv(r_yaw @ i_body @ r_yaw.T)

    base = np.zeros((13, 13), np.float32)
    base[3, 9] = base[4, 10] = base[5, 11] = 1.0
    base[11, 12] = 1.0
    drag = np.zeros((13, 13), np.float32)
    drag[11, 9] = 1.0
    a = (torch.as_tensor(base, dtype=dtype, device=dev)
         + x_drag * torch.as_tensor(drag, dtype=dtype, device=dev)
         + F.pad(r_yaw.T, (6, 4, 0, 10)))

    torque = torch.einsum("ij,fjk->fik", i_inv, _skew_feet(r_feet))     # (4,3,3)
    force = np.zeros((13, 12), np.float32)
    force[9:12] = np.tile(np.eye(3, dtype=np.float32), (1, 4)) / np.float32(cfg_mpc.mass)
    b = (torch.as_tensor(force, dtype=dtype, device=dev)
         + F.pad(torque.transpose(0, 1).reshape(3, 12), (0, 0, 6, 4)))
    return a, b


def expm_fixed(m, scaling: int = 4, order: int = 10):
    """Matrix exponential by fixed scaling and squaring with a Taylor series
    of `order` terms (static control flow), batched over leading dims."""
    ms = m / (2.0 ** scaling)
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device).expand(m.shape)
    result = eye
    term = eye
    for k in range(1, order + 1):
        term = (term @ ms) / k
        result = result + term
    for _ in range(scaling):
        result = result @ result
    return result


def discretize(a_ct, b_ct, dt: float):
    """Exact zero-order-hold discretization of the SRB dynamics, whose A is
    nilpotent of index 3: Adt = I + dt A + dt^2/2 A^2,
    Bdt = (dt I + dt^2/2 A + dt^3/6 A^2) B."""
    eye = torch.eye(13, dtype=a_ct.dtype, device=a_ct.device)
    a2 = a_ct @ a_ct
    adt = eye + dt * a_ct + (dt * dt / 2.0) * a2
    bdt = (dt * eye + (dt * dt / 2.0) * a_ct + (dt ** 3 / 6.0) * a2) @ b_ct
    return adt, bdt


def discretize_expm(a_ct, b_ct, dt: float):
    """Generic discretization by the exponential of dt [[A, B], [0, 0]]
    (for non-nilpotent dynamics; the test reference for `discretize`)."""
    abc = torch.cat([torch.cat([a_ct, b_ct], dim=-1),
                     torch.zeros((12, 25), dtype=a_ct.dtype, device=a_ct.device)], dim=-2)
    em = expm_fixed(abc * dt)
    return em[0:13, 0:13], em[0:13, 13:25]


def condense(adt, bdt, h_max: int):
    """Prediction stacking (SolverMPC.cpp:103-120): A_qp (h, 13, 13) =
    Adt^(r+1); B_qp (h, h, 13, 12) lower block-Toeplitz of Adt^(r-c) Bdt."""
    powers = [torch.eye(13, dtype=adt.dtype, device=adt.device)]
    for _ in range(h_max):
        powers.append(adt @ powers[-1])
    powers = torch.stack(powers)                                # (h+1,13,13)
    a_qp = powers[1:h_max + 1]
    pow_b = torch.einsum("hij,jk->hik", powers[:h_max], bdt)
    r = torch.arange(h_max, device=adt.device)[:, None]
    c = torch.arange(h_max, device=adt.device)[None, :]
    idx = torch.clamp(r - c, 0, h_max - 1)
    mask = (r >= c).to(adt.dtype)[:, :, None, None]
    return a_qp, pow_b[idx] * mask


def _condensed_cost(cfg_mpc: MPCConfig, bq, ax0, x_d, step_mask):
    """H = 2 (bq' S bq + alpha I), g = 2 bq' S (A x0 - x_d) with S the state
    weights on the steps of step_mask; bq (13 h, n_c) in (step, state) rows."""
    n_c = bq.shape[-1]
    s_diag = _weights(cfg_mpc, bq)[None, :] * step_mask[:, None]            # (h,13)
    sb = s_diag.reshape(-1, 1) * bq
    hess = 2.0 * (bq.T @ sb + cfg_mpc.alpha * torch.eye(n_c, dtype=bq.dtype,
                                                         device=bq.device))
    grad = 2.0 * (bq.T @ ((ax0 - x_d) * s_diag).reshape(-1))
    return hess, grad


def qp_cost(cfg_mpc: MPCConfig, a_qp, b_qp, x0, x_d, step_mask):
    """Hessian (12h, 12h) and gradient (12h,) of the condensed QP
    (SolverMPC.cpp:335-399): H = 2 (B' S B + alpha I), g = 2 B' S (A x0 - X_d)."""
    h = a_qp.shape[0]
    bq = b_qp.permute(0, 2, 1, 3).reshape(h * 13, h * 12)
    return _condensed_cost(cfg_mpc, bq, torch.einsum("hij,j->hi", a_qp, x0), x_d, step_mask)


def _ax0_closed(n1, n2, x0, h: int):
    """a_qp @ x0 without a_qp: Adt^(x+1) x0 = x0 + (x+1) N x0 + C(x+1, 2) N^2 x0."""
    nx0 = n1 @ x0
    n2x0 = n2 @ x0
    k = torch.arange(1, h + 1, dtype=x0.dtype, device=x0.device)[:, None]
    return x0[None, :] + k * nx0[None, :] + (0.5 * k * (k - 1.0)) * n2x0[None, :]


def qp_cost_nil(cfg_mpc: MPCConfig, adt, bdt, x0, x_d, step_mask):
    """`condense` + `qp_cost` through the closed-form nilpotent powers: the
    Toeplitz blocks are Bdt + k (N Bdt) + C(k, 2) (N^2 Bdt), no power chain."""
    h = x_d.shape[0]
    n1, n2, bfam = _nil_family(adt, bdt)
    phi = _phi_polys(h, adt.dtype, adt.device)
    b_qp = torch.einsum("mxc,mpj->xcpj", phi, bfam)                       # (h,h,13,12)
    bq = b_qp.permute(0, 2, 1, 3).reshape(h * 13, h * 12)
    return _condensed_cost(cfg_mpc, bq, _ax0_closed(n1, n2, x0, h), x_d, step_mask)


def compress_stance(gait_table, max_stance: int):
    """Per-step stance-foot index map for swing-variable elimination
    (SolverMPC.cpp:441-525 as a static-shape gather): each step keeps
    `max_stance` foot slots, stance feet first (a stable argsort), padding
    slots being swing feet pinned to zero by their bounds. gait_table (h, 4)
    -> (foot_idx (h, max_stance) int32, gait_red (h, max_stance))."""
    order = torch.argsort(-gait_table, dim=1, stable=True)
    foot_idx = order[:, :max_stance]
    return foot_idx.to(torch.int32), torch.take_along_dim(gait_table, foot_idx, dim=1)


def _one_hot_feet(foot_idx, dtype):
    """(h, ms) foot indices -> (h, ms, 4) one-hot selection."""
    return (foot_idx.long()[..., None]
            == torch.arange(4, device=foot_idx.device)).to(dtype)


def qp_cost_compressed(cfg_mpc: MPCConfig, a_qp, b_qp, x0, x_d, step_mask, foot_idx):
    """Hessian and gradient over the stance-foot variables of foot_idx
    (h, max_stance) only: n_c = 3 max_stance h."""
    h = a_qp.shape[0]
    n_c = h * foot_idx.shape[1] * 3
    b_red = torch.einsum("xsifz,sjf->xsijz", b_qp.reshape(h, h, 13, 4, 3),
                         _one_hot_feet(foot_idx, a_qp.dtype))
    bq = b_red.permute(0, 2, 1, 3, 4).reshape(h * 13, n_c)
    return _condensed_cost(cfg_mpc, bq, torch.einsum("hij,j->hi", a_qp, x0), x_d, step_mask)


def qp_cost_compressed_nil(cfg_mpc: MPCConfig, adt, bdt, x0, x_d, step_mask, foot_idx):
    """`condense` + `qp_cost_compressed` through the closed-form powers: the
    stance-column selection acts on the three 13 x 12 family matrices, then
    the Toeplitz combination."""
    h = x_d.shape[0]
    n_c = h * foot_idx.shape[1] * 3
    n1, n2, bfam = _nil_family(adt, bdt)
    u = torch.einsum("mpfz,cjf->mcpjz", bfam.reshape(3, 13, 4, 3),
                     _one_hot_feet(foot_idx, adt.dtype))                   # (3,h,13,ms,3)
    b_red = torch.einsum("mxc,mcpjz->xcpjz", _phi_polys(h, adt.dtype, adt.device), u)
    bq = b_red.permute(0, 2, 1, 3, 4).reshape(h * 13, n_c)
    return _condensed_cost(cfg_mpc, bq, _ax0_closed(n1, n2, x0, h), x_d, step_mask)
