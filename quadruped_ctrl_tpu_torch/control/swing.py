"""Bezier swing trajectories and Raibert-style foot placement.

The counterpart of `quadruped_ctrl_tpu/control/swing.py`: re-derivations of
FootSwingTrajectory (reference Controllers/FootSwingTrajectory.cpp:16-37)
and the foot-placement block of ConvexMPCLocomotion::run
(ConvexMPCLocomotion.cpp:297-371). Vectorized over all 4 feet; runs under
`torch.func.vmap` over robots.
"""

from __future__ import annotations

import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import FrameworkConfig
from quadruped_ctrl_tpu_torch.core.interpolation import (
    cubic_bezier,
    cubic_bezier_d1,
    cubic_bezier_d2,
)
from quadruped_ctrl_tpu_torch.core.rotations import coordinate_rotation_z


def _with_z(v, z):
    """v (..., 3) with its last entry replaced by z (...)."""
    return torch.cat([v[..., :2], z[..., None]], dim=-1)


def swing_trajectory(p0, pf, height, phase, swing_time):
    """Position/velocity/acceleration along the swing.

    p0, pf: (..., 3) liftoff / touchdown (world). phase in [0,1].
    x/y follow one cubic Bezier; z is two half-Beziers via an apex at
    p0.z + height (FootSwingTrajectory.cpp:17-37).
    Returns (p, v, a) each (..., 3).
    """
    ph = phase[..., None]
    st = swing_time[..., None]
    p = cubic_bezier(p0, pf, ph)
    v = cubic_bezier_d1(p0, pf, ph) / st
    a = cubic_bezier_d2(p0, pf, ph) / (st * st)

    z0, zf = p0[..., 2], pf[..., 2]
    apex = z0 + height
    first = phase < 0.5
    x1 = phase * 2.0
    x2 = phase * 2.0 - 1.0
    stz = swing_time
    zp = torch.where(first, cubic_bezier(z0, apex, x1), cubic_bezier(apex, zf, x2))
    zv = torch.where(
        first,
        cubic_bezier_d1(z0, apex, x1) * 2.0 / stz,
        cubic_bezier_d1(apex, zf, x2) * 2.0 / stz,
    )
    za = torch.where(
        first,
        cubic_bezier_d2(z0, apex, x1) * 4.0 / (stz * stz),
        cubic_bezier_d2(apex, zf, x2) * 4.0 / (stz * stz),
    )
    return _with_z(p, zp), _with_z(v, zv), _with_z(a, za)


def foot_placement(
    cfg: FrameworkConfig,
    hip_locations,       # (4,3) body-frame hip positions
    position,            # (3,) body position (world)
    r_body_t,            # (3,3) body->world rotation (rBody^T)
    v_world,             # (3,) body velocity (world)
    v_des_robot,         # (3,) desired body-frame velocity
    v_des_world,         # (3,)
    yaw_turn_rate,       # ()
    stance_times,        # (4,) seconds
    swing_time_remaining,  # (4,) seconds
):
    """Touchdown targets Pf for all 4 feet (ConvexMPCLocomotion.cpp:297-371).

    Hip projection (with yaw correction over half a stance), half-stance
    velocity feedforward, velocity-error term, and a capture-point omega
    cross-coupling term; xy clamped to +-p_rel_max, z = 0.
    """
    sw = cfg.swing
    dev, dtype = position.device, position.dtype
    side = _device.constant(cfg.robot.side_signs, dev, dtype)
    interleave = _device.constant(sw.interleave_y, dev, dtype)
    zero4 = torch.zeros(4, dtype=dtype, device=dev)
    p_robot = hip_locations + torch.stack([zero4, side * sw.side_offset_y, zero4], dim=-1)
    v_abs = v_des_robot[0].abs()
    p_robot = p_robot + torch.stack(
        [zero4, interleave * v_abs * sw.interleave_gain, zero4], dim=-1)

    rot = coordinate_rotation_z(-yaw_turn_rate * stance_times / 2.0)  # (4,3,3)
    p_yaw_corrected = torch.einsum("fij,fj->fi", rot, p_robot)

    pf = position[None, :] + torch.einsum(
        "ij,fj->fi",
        r_body_t,
        p_yaw_corrected + v_des_robot[None, :] * swing_time_remaining[:, None],
    )

    cap = sw.capture_point_factor * torch.sqrt(torch.clamp(position[2], min=1e-6) / 9.81)
    pfx_rel = (
        v_world[0] * (0.5 + sw.bonus_swing) * stance_times
        + sw.vel_err_gain * (v_world[0] - v_des_world[0])
        + cap * (v_world[1] * yaw_turn_rate)
    )
    pfy_rel = (
        v_world[1] * 0.5 * stance_times
        + sw.vel_err_gain * (v_world[1] - v_des_world[1])
        + cap * (-v_world[0] * yaw_turn_rate)
    )
    pfx_rel = torch.clamp(pfx_rel, -sw.p_rel_max, sw.p_rel_max)
    pfy_rel = torch.clamp(pfy_rel, -sw.p_rel_max, sw.p_rel_max)
    return torch.stack([pf[:, 0] + pfx_rel, pf[:, 1] + pfy_rel, zero4], dim=-1)
