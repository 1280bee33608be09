"""18-state linear Kalman filter for body position/velocity.

The counterpart of `quadruped_ctrl_tpu/estimation/linear_kf.py`, a
re-derivation of LinearKFPositionVelocityEstimator (reference
Controllers/PositionVelocityEstimator.cpp:18-221): state
x = [p(3), v(3), p_foot0..3(12)], 28 measurements (4x relative foot position,
4x foot velocity, 4x foot height), with per-foot contact-"trust" scaling of
the process/measurement noise.

`run` (one robot) inverts the SPD 28x28 innovation covariance with the JAX
package's Jacobi-prescaled scaled Newton-Schulz iteration (its schedule from
`ops/ns_inverse.mu_schedule`) plus two refinement passes, in place of the
reference's two LU solves. `run_batched` is the batch-explicit filter the
closed loop runs: the joint 28-measurement update as 28 sequential scalar
updates in Joseph form, exact for this filter's diagonal R. Its covariance is
laid out (B,18,18) here; the JAX package keeps it batch-last for the TPU's
lanes, which has no counterpart on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import EstimatorConfig
from quadruped_ctrl_tpu_torch.ops.ns_inverse import mu_schedule


def _static_mats(cfg: EstimatorConfig):
    """A, B, C, Q0 diag, R0 = I as numpy constants (setup(), lines 18-57)."""
    dt = cfg.dt
    a = np.eye(18, dtype=np.float32)
    a[0:3, 3:6] = dt * np.eye(3, dtype=np.float32)
    b = np.zeros((18, 3), dtype=np.float32)
    b[3:6, :] = dt * np.eye(3, dtype=np.float32)
    c = np.zeros((28, 18), dtype=np.float32)
    c1 = np.hstack([np.eye(3), np.zeros((3, 3))]).astype(np.float32)
    c2 = np.hstack([np.zeros((3, 3)), np.eye(3)]).astype(np.float32)
    for i in range(4):
        c[3 * i : 3 * i + 3, 0:6] = c1
        c[12 + 3 * i : 15 + 3 * i, 0:6] = c2
    c[0:12, 6:18] = -np.eye(12, dtype=np.float32)
    c[24, 8] = 1.0
    c[25, 11] = 1.0
    c[26, 14] = 1.0
    c[27, 17] = 1.0
    q0 = np.ones(18, dtype=np.float32)
    q0[0:3] = (dt / 20.0) * cfg.process_noise_pimu
    q0[3:6] = (dt * 9.8 / 20.0) * cfg.process_noise_vimu
    q0[6:18] = dt * cfg.process_noise_pfoot
    r0 = np.ones(28, dtype=np.float32)
    r0[0:12] = cfg.sensor_noise_pimu_rel_foot
    r0[12:24] = cfg.sensor_noise_vimu_rel_foot
    r0[24:28] = cfg.sensor_noise_zfoot
    return a, b, c, q0, r0


def _xy_mask() -> np.ndarray:
    """False on the xy-position rows' and columns' coupling to the rest."""
    mask = np.ones((18, 18), dtype=bool)
    mask[0:2, 2:18] = False
    mask[2:18, 0:2] = False
    return mask


def _trust(cfg: EstimatorConfig, contact_phase):
    phase = torch.clamp(contact_phase, max=1.0)
    tw = cfg.trust_window
    return torch.where(
        phase < tw, phase / tw, torch.where(phase > 1.0 - tw, (1.0 - phase) / tw, 1.0)
    )


def run(
    cfg: EstimatorConfig,
    xhat,                # (18,)
    p_cov,               # (18,18)
    a_world,             # (3,) world-frame acceleration (with +g bias still in)
    r_body,              # (3,3)
    omega_body,          # (3,)
    hip_locations,       # (4,3)
    leg_p,               # (4,3) foot pos in hip frame
    leg_v,               # (4,3) foot vel in hip frame
    contact_phase,       # (4,)
):
    """One KF step. Returns (xhat, P, position, v_world, v_body)."""
    dev, dtype = xhat.device, xhat.dtype
    A, B, C, q0_diag, r0_diag = (_device.constant(m, dev) for m in _static_mats(cfg))

    g = _device.constant([0.0, 0.0, -cfg.gravity], dev)
    rbod = r_body.T
    a = a_world + g

    p0, v0 = xhat[0:3], xhat[3:6]

    p_rel = hip_locations + leg_p                       # (4,3) body frame
    dp_rel = leg_v
    p_f = torch.einsum("ij,fj->fi", rbod, p_rel)        # world frame
    dp_f = torch.einsum(
        "ij,fj->fi", rbod,
        torch.linalg.cross(omega_body.expand(4, 3), p_rel) + dp_rel,
    )

    trust = _trust(cfg, contact_phase)
    suspect = 1.0 + (1.0 - trust) * cfg.high_suspect_number  # (4,)

    # noise assembly (run(), lines 74-169)
    q_diag = torch.cat([q0_diag[0:6], (q0_diag[6:18].reshape(4, 3) * suspect[:, None]
                                       ).reshape(12)])
    r_diag = torch.cat([r0_diag[0:12],
                        (r0_diag[12:24].reshape(4, 3) * suspect[:, None]).reshape(12),
                        r0_diag[24:28] * suspect])

    ps = (-p_f).reshape(12)
    vs = ((1.0 - trust)[:, None] * v0[None, :] + trust[:, None] * (-dp_f)).reshape(12)
    pzs = (1.0 - trust) * (p0[2] + p_f[:, 2])
    y = torch.cat([ps, vs, pzs])

    # predict
    xhat = A @ xhat + B @ a
    pm = A @ p_cov @ A.T + torch.diag_embed(q_diag)

    # update: the scaled Newton-Schulz inverse of the Jacobi-prescaled SPD
    # innovation covariance (the reference: two LU solves, lines 171-186)
    ey = y - C @ xhat
    s = C @ pm @ C.T + torch.diag_embed(r_diag)
    d = torch.rsqrt(torch.clamp(torch.diagonal(s), min=1e-30))
    ss = s * d[:, None] * d[None, :]
    eye28 = torch.eye(28, dtype=dtype, device=dev)
    x = (1.0 / torch.amax(torch.sum(ss.abs(), dim=-1))) * eye28
    for mu in mu_schedule(1e-8, 14):     # interval phase: handles cond 1e8
        x = mu * (x @ (2.0 * eye28 - mu * (ss @ x)))
    for _ in range(4):                   # quadratic phase to the f32 floor
        x = x @ (2.0 * eye28 - ss @ x)
    inv_s = x * d[:, None] * d[None, :]

    def s_solve(b):
        sol = inv_s @ b
        for _ in range(2):               # refinement: error ~r^3
            sol = sol + inv_s @ (b - s @ sol)
        return sol

    s_ey = s_solve(ey)
    pct = pm @ C.T
    xhat = xhat + pct @ s_ey
    s_c = s_solve(C)
    p_cov = (torch.eye(18, dtype=dtype, device=dev) - pct @ s_c) @ pm
    p_cov = 0.5 * (p_cov + p_cov.T)

    # xy-covariance conditioning hack (lines 191-195)
    det2 = p_cov[0, 0] * p_cov[1, 1] - p_cov[0, 1] * p_cov[1, 0]
    cond = det2 > 1e-6
    p_fixed = torch.where(_device.constant(_xy_mask(), dev, torch.bool), p_cov, 0.0)
    p_fixed = torch.cat([torch.cat([p_fixed[0:2, 0:2] / 10.0, p_fixed[0:2, 2:]], dim=1),
                         p_fixed[2:]], dim=0)
    p_cov = torch.where(cond, p_fixed, p_cov)

    position = xhat[0:3]
    v_world = xhat[3:6]
    v_body = r_body @ v_world
    return xhat, p_cov, position, v_world, v_body


def _meas_rows():
    """The 28 measurement rows of C as (j1, j2) index pairs: each row is
    e_j1 - e_j2 (j2 = None for single-entry rows). Mirrors _static_mats."""
    rows = []
    for f in range(4):                      # p - p_foot (world-relative)
        for ax in range(3):
            rows.append((ax, 6 + 3 * f + ax))
    for f in range(4):                      # body velocity
        for ax in range(3):
            rows.append((3 + ax, None))
    for f in range(4):                      # foot height
        rows.append((6 + 3 * f + 2, None))
    return rows


def run_batched(
    cfg: EstimatorConfig,
    xhat,                # (B,18)
    p_cov,               # (B,18,18)
    a_world,             # (B,3)
    r_body,              # (B,3,3)
    omega_body,          # (B,3)
    hip_locations,       # (4,3) static
    leg_p,               # (B,4,3)
    leg_v,               # (B,4,3)
    contact_phase,       # (B,4)
):
    """Batch-explicit KF step, the same estimate as `run` per scenario.

    The joint 28-measurement update runs as 28 sequential scalar updates,
    textbook-exact for the diagonal R this filter has (the reference's R0 +
    trust scaling, PositionVelocityEstimator.cpp:45-57): each row's gain is
    a difference of P's columns over a scalar innovation variance, so the
    28x28 innovation solve disappears. Each update is in Joseph form, two
    rank-1 passes over P, which keeps the filter symmetric-PSD through the
    initial_p=100 transient where the plain P - k(Pc)' update is
    f32-fragile. The covariance is (B,18,18).
    """
    dt = cfg.dt
    dtype, dev = xhat.dtype, xhat.device
    bsz = xhat.shape[0]
    _, _, _, q0_np, r0_np = _static_mats(cfg)
    q0_diag = _device.constant(q0_np, dev)
    r0_diag = _device.constant(r0_np, dev)

    g = _device.constant([0.0, 0.0, -cfg.gravity], dev)
    rbod = r_body.transpose(-1, -2)
    a = a_world + g

    p0, v0 = xhat[:, 0:3], xhat[:, 3:6]
    p_rel = hip_locations[None] + leg_p                  # (B,4,3) body frame
    p_f = torch.einsum("bij,bfj->bfi", rbod, p_rel)      # world frame
    dp_f = torch.einsum(
        "bij,bfj->bfi", rbod,
        torch.linalg.cross(omega_body[:, None, :].expand(p_rel.shape), p_rel) + leg_v,
    )

    trust = _trust(cfg, contact_phase)
    suspect = 1.0 + (1.0 - trust) * cfg.high_suspect_number  # (B,4)

    q_diag = torch.cat([
        q0_diag[0:6].expand(bsz, 6),
        (q0_diag[6:18].reshape(4, 3)[None] * suspect[:, :, None]).reshape(-1, 12),
    ], dim=1)                                             # (B,18)
    r_diag = torch.cat([
        r0_diag[0:12].expand(bsz, 12),
        (r0_diag[12:24].reshape(4, 3)[None] * suspect[:, :, None]).reshape(-1, 12),
        r0_diag[None, 24:28] * suspect,
    ], dim=1)                                             # (B,28)

    ps = (-p_f).reshape(-1, 12)
    vs = ((1.0 - trust)[:, :, None] * v0[:, None, :]
          + trust[:, :, None] * (-dp_f)).reshape(-1, 12)
    pzs = (1.0 - trust) * (p0[:, 2:3] + p_f[:, :, 2])
    y = torch.cat([ps, vs, pzs], dim=1)                   # (B,28)

    # predict: A = I + dt E (E: p<-v), B a = dt a on v — slice algebra
    x = torch.cat([p0 + dt * v0, v0 + dt * a, xhat[:, 6:18]], dim=1)   # (B,18)
    pm = torch.cat([p_cov[:, 0:3] + dt * p_cov[:, 3:6], p_cov[:, 3:18]], dim=1)
    pm = torch.cat([pm[:, :, 0:3] + dt * pm[:, :, 3:6], pm[:, :, 3:18]], dim=2)
    pm = pm + torch.diag_embed(q_diag)

    def p_col(p, j1, j2):
        if j2 is None:
            return p[:, :, j1]                            # (B,18) = P c
        return p[:, :, j1] - p[:, :, j2]

    for i, (j1, j2) in enumerate(_meas_rows()):
        pmc = p_col(pm, j1, j2)
        cx = x[:, j1] - (x[:, j2] if j2 is not None else 0.0)
        s = (pmc[:, j1] - (pmc[:, j2] if j2 is not None else 0.0)) + r_diag[:, i]
        gain = pmc / s[:, None]
        x = x + gain * (y[:, i] - cx)[:, None]
        pm = pm - gain[:, :, None] * pmc[:, None, :]      # (I - kc')P
        p1c = p_col(pm, j1, j2)                           # ((I-kc')P) c
        pm = (pm - p1c[:, :, None] * gain[:, None, :]
              + (r_diag[:, i, None] * gain)[:, :, None] * gain[:, None, :])

    pm = 0.5 * (pm + pm.transpose(1, 2))

    # xy-covariance conditioning hack (reference lines 191-195)
    det2 = pm[:, 0, 0] * pm[:, 1, 1] - pm[:, 0, 1] * pm[:, 1, 0]   # (B,)
    cond = det2 > 1e-6
    p_fixed = torch.where(_device.constant(_xy_mask(), dev, torch.bool), pm, 0.0)
    scale2 = np.ones((18, 18), np.float32)
    scale2[0:2, 0:2] = 0.1
    p_fixed = p_fixed * _device.constant(scale2, dev)
    pm = torch.where(cond[:, None, None], p_fixed, pm)

    position = x[:, 0:3]
    v_world = x[:, 3:6]
    v_body = torch.einsum("bij,bj->bi", r_body, v_world)
    return x, pm, position, v_world, v_body
