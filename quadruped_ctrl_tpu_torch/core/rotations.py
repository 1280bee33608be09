"""Rotation conventions, matching the reference exactly.

The reference uses Featherstone-style "coordinate transformation" matrices:
``rBody`` satisfies ``vBody = rBody @ vWorld`` (orientation_tools.h:170-188 —
the standard quaternion rotation matrix, transposed). Quaternions are (w,x,y,z).
``quat_to_rpy`` uses ZYX (yaw-pitch-roll) order, returned as (roll,pitch,yaw)
(orientation_tools.h:195-208). ``coordinate_rotation_z(theta)`` transforms
*into* a frame rotated by theta (orientation_tools.h:59-76).

All functions broadcast over leading batch dims and run under
`torch.func.vmap`.
"""

from __future__ import annotations

import torch


def quat_to_rot(q):
    """Body->world rotation matrix from a (w,x,y,z) quaternion.

    This is the *untransposed* matrix from orientation_tools.h:181-185;
    the reference's rBody is its transpose.
    """
    e0, e1, e2, e3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (e2 * e2 + e3 * e3), 2 * (e1 * e2 - e0 * e3), 2 * (e1 * e3 + e0 * e2),
            2 * (e1 * e2 + e0 * e3), 1 - 2 * (e1 * e1 + e3 * e3), 2 * (e2 * e3 - e0 * e1),
            2 * (e1 * e3 - e0 * e2), 2 * (e2 * e3 + e0 * e1), 1 - 2 * (e1 * e1 + e2 * e2),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_to_rbody(q):
    """vBody = rbody @ vWorld (reference orientation_tools.h:170-188)."""
    return quat_to_rot(q).transpose(-1, -2)


def quat_to_rpy(q):
    """(roll, pitch, yaw), ZYX convention (orientation_tools.h:195-208).

    The reference clamps only the +1 side of asin's argument; both sides are
    clamped here to avoid NaN (the reference would NaN there too, so
    behaviour only differs where the reference is already broken).
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    as_ = torch.clamp(-2.0 * (x * z - w * y), -0.99999, 0.99999)
    yaw = torch.atan2(2 * (x * y + w * z), w * w + x * x - y * y - z * z)
    pitch = torch.asin(as_)
    roll = torch.atan2(2 * (y * z + w * x), w * w - x * x - y * y + z * z)
    return torch.stack([roll, pitch, yaw], dim=-1)


def rpy_to_quat(rpy):
    """(w,x,y,z) quaternion from (roll,pitch,yaw), ZYX composition.

    Matches reference rpyToQuat (orientation_tools.h:211-217) round-trip:
    quat_to_rpy(rpy_to_quat(v)) == v for |pitch| < pi/2.
    """
    r, p, y = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def quat_product(q1, q2):
    """Hamilton product (orientation_tools.h:272-283)."""
    r1, v1 = q1[..., :1], q1[..., 1:]
    r2, v2 = q2[..., :1], q2[..., 1:]
    r = r1 * r2 - torch.sum(v1 * v2, dim=-1, keepdim=True)
    v = r1 * v2 + r2 * v1 + torch.linalg.cross(v1, v2)
    return torch.cat([r, v], dim=-1)


def quat_integrate(q, omega_body, dt):
    """Integrate a quaternion by a body-frame angular velocity over dt.

    Exponential-map update (reference orientation_tools.h quaternion
    derivative utilities); used by the SRB simulator, not the controller.
    """
    ang = torch.linalg.vector_norm(omega_body, dim=-1, keepdim=True)
    axis = omega_body / torch.clamp(ang, min=1e-9)
    half = 0.5 * ang * dt
    dq = torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)
    qn = quat_product(q, dq)
    return qn / torch.linalg.vector_norm(qn, dim=-1, keepdim=True)


def rot_z(yaw):
    """Standard active rotation about z (RobotState.cpp:33-35 R_yaw)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    r = torch.stack([c, -s, zero, s, c, zero, zero, zero, one], dim=-1)
    return r.reshape(yaw.shape + (3, 3))


def coordinate_rotation_z(theta):
    """Featherstone coordinate rotation about z: transforms INTO the rotated
    frame (orientation_tools.h:71-72); equals rot_z(-theta)."""
    return rot_z(-theta)


def cross_matrix(v):
    """Skew-symmetric matrix [v]x (orientation_tools.h:79-87)."""
    zero = torch.zeros_like(v[..., 0])
    m = torch.stack(
        [zero, -v[..., 2], v[..., 1],
         v[..., 2], zero, -v[..., 0],
         -v[..., 1], v[..., 0], zero],
        dim=-1,
    )
    return m.reshape(v.shape[:-1] + (3, 3))
