"""6D spatial algebra (Featherstone conventions).

The counterpart of `quadruped_ctrl_tpu/models/spatial.py`, a re-derivation of
the reference's spatial substrate (src/Dynamics/spatial.h, SpatialInertia.h):
Plücker coordinate transforms, motion/force cross products, and spatial
inertia construction. Motion vectors are [omega; v], force vectors [n; f];
transforms are 6x6 Plücker matrices X = [[R, 0], [-R [p]x, R]] mapping motion
vectors from frame A to B where R rotates A into B and p locates B's origin in
A. Plain tensor functions, batched over leading dims.
"""

from __future__ import annotations

import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.core.rotations import cross_matrix


def xform(rot, p):
    """Plücker motion transform from (R, p). rot: (...,3,3), p: (...,3)."""
    z = torch.zeros_like(rot)
    top = torch.cat([rot, z], dim=-1)
    bot = torch.cat([-rot @ cross_matrix(p), rot], dim=-1)
    return torch.cat([top, bot], dim=-2)


def xform_rot(x):
    return x[..., 0:3, 0:3]


def xform_force(x):
    """Force-vector version of a motion transform: X* = [[R, -R[p]x],[0, R]]."""
    r = x[..., 0:3, 0:3]
    skew = x[..., 3:6, 0:3]
    top = torch.cat([r, skew], dim=-1)
    bot = torch.cat([torch.zeros_like(r), r], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inv_xform(x):
    """Inverse of a Plücker motion transform."""
    r = x[..., 0:3, 0:3]
    rt = r.transpose(-1, -2)
    skew = x[..., 3:6, 0:3]
    top = torch.cat([rt, torch.zeros_like(r)], dim=-1)
    bot = torch.cat([skew.transpose(-1, -2), rt], dim=-1)
    return torch.cat([top, bot], dim=-2)


def motion_cross(v):
    """vx for motion vectors: [[wx, 0], [vx, wx]] (spatial.h motionCrossMatrix)."""
    w = cross_matrix(v[..., 0:3])
    vl = cross_matrix(v[..., 3:6])
    top = torch.cat([w, torch.zeros_like(w)], dim=-1)
    bot = torch.cat([vl, w], dim=-1)
    return torch.cat([top, bot], dim=-2)


def force_cross(v):
    """vx* for force vectors: [[wx, vx], [0, wx]]."""
    w = cross_matrix(v[..., 0:3])
    vl = cross_matrix(v[..., 3:6])
    top = torch.cat([w, vl], dim=-1)
    bot = torch.cat([torch.zeros_like(w), w], dim=-1)
    return torch.cat([top, bot], dim=-2)


def spatial_inertia(mass, com, inertia_about_com):
    """6x6 spatial inertia from mass, CoM offset, rotational inertia about
    the CoM (SpatialInertia.h constructor)."""
    c = cross_matrix(com)
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    i_bar = inertia_about_com + mass * (c @ c.T)
    top = torch.cat([i_bar, mass * c], dim=-1)
    bot = torch.cat([mass * c.T, mass * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def rot_axis(axis: int, theta):
    """Featherstone coordinate rotation about a coordinate axis
    (orientation_tools.h:59-76 conventions: transforms INTO the rotated frame)."""
    c, s = torch.cos(theta), torch.sin(theta)
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    if axis == 0:
        rows = [one, zero, zero, zero, c, s, zero, -s, c]
    elif axis == 1:
        rows = [c, zero, -s, zero, one, zero, s, zero, c]
    else:
        rows = [c, s, zero, -s, c, zero, zero, zero, one]
    return torch.stack(rows, dim=-1).reshape(theta.shape + (3, 3))


def joint_xform(axis: int, theta):
    """Revolute joint transform about a coordinate axis."""
    return xform(rot_axis(axis, theta), theta.new_zeros(theta.shape + (3,)))


def joint_motion_subspace(axis: int, dtype=torch.float32, device=None):
    """Motion subspace S for a revolute joint about a coordinate axis, on
    `device` (cuda:0 unless named)."""
    s = torch.zeros((6,), dtype=dtype, device=_device.resolve(device))
    s[axis] = 1.0
    return s
