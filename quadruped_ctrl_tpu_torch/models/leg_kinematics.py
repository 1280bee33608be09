"""Analytic 3-DoF leg kinematics: FK, Jacobian, IK.

The counterpart of `quadruped_ctrl_tpu/models/leg_kinematics.py`, a
re-derivation of the Mini-Cheetah leg geometry used by the reference
(LegController.cpp:203-287). All functions are vectorized over all 4 legs at
once, shape (4, 3) in/out, and run under `torch.func.vmap`.

Leg frame: origin at the ab/ad pivot, same orientation as the body frame.
Joint order per leg: [abad, hip, knee]. side_sign = (-1, +1, -1, +1) for
legs (FR, FL, HR, HL).
"""

from __future__ import annotations

import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import RobotConfig


def _link_lengths(robot: RobotConfig):
    return (
        robot.abad_link_length,
        robot.hip_link_length,
        robot.knee_link_length,
        robot.knee_link_y_offset,
    )


def _side(robot: RobotConfig, like: torch.Tensor) -> torch.Tensor:
    return _device.constant(robot.side_signs, like.device, like.dtype)


def leg_fk(robot: RobotConfig, q: torch.Tensor) -> torch.Tensor:
    """Foot position in each leg's hip frame. q: (..., 4, 3) -> (..., 4, 3).

    Matches reference computeLegJacobianAndPosition (LegController.cpp:237-243).
    """
    l1, l2, l3, l4 = _link_lengths(robot)
    side = _side(robot, q)
    s1, s2, s3 = torch.sin(q[..., 0]), torch.sin(q[..., 1]), torch.sin(q[..., 2])
    c1, c2, c3 = torch.cos(q[..., 0]), torch.cos(q[..., 1]), torch.cos(q[..., 2])
    c23 = c2 * c3 - s2 * s3
    s23 = s2 * c3 + c2 * s3
    px = l3 * s23 + l2 * s2
    py = (l1 + l4) * side * c1 + l3 * (s1 * c23) + l2 * c2 * s1
    pz = (l1 + l4) * side * s1 - l3 * (c1 * c23) - l2 * c1 * c2
    return torch.stack([px, py, pz], dim=-1)


def leg_jacobian(robot: RobotConfig, q: torch.Tensor) -> torch.Tensor:
    """Foot Jacobian d p / d q. q: (..., 4, 3) -> (..., 4, 3, 3).

    Matches reference computeLegJacobianAndPosition (LegController.cpp:223-235).
    """
    l1, l2, l3, l4 = _link_lengths(robot)
    side = _side(robot, q)
    s1, s2, s3 = torch.sin(q[..., 0]), torch.sin(q[..., 1]), torch.sin(q[..., 2])
    c1, c2, c3 = torch.cos(q[..., 0]), torch.cos(q[..., 1]), torch.cos(q[..., 2])
    c23 = c2 * c3 - s2 * s3
    s23 = s2 * c3 + c2 * s3
    zero = torch.zeros_like(s1)
    rows = [
        zero, l3 * c23 + l2 * c2, l3 * c23,
        l3 * c1 * c23 + l2 * c1 * c2 - (l1 + l4) * side * s1,
        -l3 * s1 * s23 - l2 * s1 * s2,
        -l3 * s1 * s23,
        l3 * s1 * c23 + l2 * c2 * s1 + (l1 + l4) * side * c1,
        l3 * c1 * s23 + l2 * c1 * s2,
        l3 * c1 * s23,
    ]
    jac = torch.stack(rows, dim=-1)
    return jac.reshape(q.shape[:-1] + (3, 3))


def leg_ik(robot: RobotConfig, p_des: torch.Tensor, knee_sign: float = 1.0) -> torch.Tensor:
    """Joint angles for a desired hip-frame foot position (true FK inverse).

    p_des: (..., 4, 3) -> q: (..., 4, 3). The abad solution and the knee
    cosine match the reference computeLegIK (LegController.cpp:255-287, incl.
    the out-of-domain D clamping); the hip angle is the FK's own inverse
    (the reference's atan2(-x, ...) sign-flips x), so
    leg_fk(leg_ik(p)) == p.

    knee_sign=+1 selects the knee-forward branch used by the robot's crouch
    pose (q_knee ~ +1.6); -1 selects the reference's branch.
    """
    l1 = robot.abad_link_length + robot.knee_link_y_offset
    l2 = robot.hip_link_length
    l3 = robot.knee_link_length
    side = _side(robot, p_des)
    x, y, z = p_des[..., 0], p_des[..., 1], p_des[..., 2]

    d = (x * x + y * y + z * z - l1 * l1 - l2 * l2 - l3 * l3) / (2 * l2 * l3)
    d = torch.clamp(d, -0.99999, 0.99999)
    gamma = torch.atan2(knee_sign * torch.sqrt(1.0 - d * d), d)

    u = torch.sqrt(torch.clamp(y * y + z * z - l1 * l1, min=1e-12))
    q0 = torch.atan2(z, y) + torch.atan2(u, side * l1)
    alpha = torch.atan2(x, u) - torch.atan2(
        l3 * torch.sin(gamma), l2 + l3 * torch.cos(gamma)
    )
    return torch.stack([q0, alpha, gamma], dim=-1)


def foot_velocity(jac: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """v = J @ qd per leg (LegController.cpp:106)."""
    return torch.einsum("...ij,...j->...i", jac, qd)
