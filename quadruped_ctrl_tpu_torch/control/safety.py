"""Vectorized safety checker.

The counterpart of `quadruped_ctrl_tpu/control/safety.py`, a re-derivation
of SafetyChecker (reference Controllers/SafetyChecker.cpp:19-278) plus the
latching failure semantics of GaitCtrller::TorqueCalculator
(GaitCtrller.cpp:108-142): any failed check latches `safety_ok=False` and the
controller outputs zero torques forever after. Clamps are applied like the
reference (the checks modify the offending commands *and* flag failure).
"""

from __future__ import annotations

import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import RobotConfig, SafetyConfig


def check_orientation(cfg: SafetyConfig, rpy):
    """|roll|,|pitch| < 0.5 rad (SafetyChecker.cpp:20-28)."""
    return (rpy[0].abs() < cfg.rpy_limit) & (rpy[1].abs() < cfg.rpy_limit)


def check_p_des_foot(cfg: SafetyConfig, robot: RobotConfig, p_des):
    """Clamp desired foot positions to the reach box (SafetyChecker.cpp:34-121).

    p_des: (4,3). Returns (clamped, ok).
    """
    max_p = robot.max_leg_length * float(torch.sin(torch.tensor(cfg.max_foot_angle,
                                                                dtype=torch.float32)))
    xy = p_des[:, :2]
    xy_c = torch.clamp(xy, -max_p, max_p)
    z_c = torch.clamp(p_des[:, 2], min=-robot.max_leg_length)
    clamped = torch.cat([xy_c, z_c[:, None]], dim=1)
    ok = (xy.abs() <= max_p).all() & (p_des[:, 2] >= -robot.max_leg_length).all()
    return clamped, ok


def check_joint_limits(cfg: SafetyConfig, q):
    """Clamp joint angles (SafetyChecker.cpp:127-170). q: (4,3)."""
    lo = _device.constant([-cfg.max_abad_angle, cfg.min_hip_angle, cfg.min_knee_angle],
                          q.device, q.dtype)
    hi = _device.constant([cfg.max_abad_angle, cfg.max_hip_angle, cfg.max_knee_angle],
                          q.device, q.dtype)
    clamped = torch.clamp(q, lo[None, :], hi[None, :])
    ok = ((q >= lo[None, :]) & (q <= hi[None, :])).all()
    return clamped, ok


def check_force_feedforward(cfg: SafetyConfig, f_ff):
    """Clamp feedforward forces to +-350 N (SafetyChecker.cpp:176-275). f_ff: (4,3)."""
    lim = _device.constant(
        [cfg.max_lateral_force, cfg.max_lateral_force, cfg.max_vertical_force],
        f_ff.device, f_ff.dtype)
    clamped = torch.clamp(f_ff, -lim[None, :], lim[None, :])
    ok = (f_ff.abs() <= lim[None, :]).all()
    return clamped, ok
