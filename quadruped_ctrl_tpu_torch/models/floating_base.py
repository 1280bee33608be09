"""Floating-base rigid-body dynamics for the Mini-Cheetah (18 DoF).

The counterpart of `quadruped_ctrl_tpu/models/floating_base.py`, the port of
the reference's FloatingBaseModel (src/Dynamics/FloatingBaseModel.{cpp,h},
built by Quadruped::buildModel, src/Dynamics/Quadruped.cpp:117-206): a fixed
13-body kinematic tree (base + 4x abad/hip/knee) with the MiniCheetah.h:19-112
CAD inertias and the reference's explicit geared rotors, supporting forward
kinematics, the mass matrix by CRBA, the bias forces by RNEA, world-frame
contact Jacobians, forward dynamics qdd = M^-1 (tau - h), the
Articulated-Body Algorithm and the operational-space contact tools.

The tree is the base and four legs of the same shape (abad -> hip -> knee),
so every recursion here runs over the three depths of a leg with the four
legs as a batch axis, and only the base step sums over the legs, in the JAX
package's order (leg 3 first). The per-body quantities are stacked tensors:
index b = 3 * leg + joint for the 12 moving bodies, body i = b + 1 in the JAX
package's numbering. The arithmetic is the JAX package's, but for two exact
shortcuts: a product with the identity is dropped, and a transform's force
dual of its inverse, `xform_force(inv_xform(X))`, which is X^T exactly, is
taken as the transpose.

Velocity convention: `base_vel` is the base's spatial velocity [omega; v] in
BASE coordinates; q (12,) joint angles in the leg_kinematics convention
(abad +X, hip/knee -Y rotations); generalized coordinate order
[base(6), leg0(3), ..., leg3(3)].
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import RobotConfig
from quadruped_ctrl_tpu_torch.models import spatial as sp

N_BODIES = 13           # base + 4 legs x 3 links
N_DOF = 18

# per-moving-body: (parent body index, joint axis, joint sign)
# bodies 1..12 = [abad, hip, knee] x legs 0..3
_JOINT_AXIS = [0, 1, 1]        # abad about X, hip/knee about Y
_JOINT_SIGN = [1.0, -1.0, -1.0]


def _mirror_y(inertia, side):
    """Reflect a rotational inertia across the xz-plane for right legs."""
    s = np.diag([1.0, side, 1.0])
    return s @ inertia @ s


def _mv(a, v):
    """Batched matrix-vector product a (..., m, n) @ v (..., n)."""
    return (a @ v[..., None])[..., 0]


def _dot(a, b):
    return (a * b).sum(-1)


def _per_leg(t):
    """(12, ...) per-moving-body tensor -> (4, 3, ...) [leg, joint]."""
    return t.reshape((4, 3) + tuple(t.shape[1:]))


class MiniCheetahModel:
    """Tree constants (float32 tensors on the model's device) and the
    dynamics as methods on unbatched tensors of that device.

    `device` is the port's own (cuda:0 unless named). The constants are
    computed as the JAX package computes them, in float32 on the CPU, and
    moved to the device once."""

    def __init__(self, robot: RobotConfig | None = None, device=None):
        r = robot or RobotConfig()
        self.robot = r
        self.device = dev = _device.resolve(device)
        cpu = torch.device("cpu")
        l2, l3 = r.hip_link_length, r.knee_link_length
        l1, l4 = r.abad_link_length, r.knee_link_y_offset

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32))

        eye3 = torch.eye(3)

        def inertia(mass, com, rot_inertia):
            return sp.spatial_inertia(f32(mass), f32(com), f32(rot_inertia))

        parents = [-1]
        x_tree = [torch.eye(6)]
        inertias = [inertia(r.body_mass, np.zeros(3),
                            np.diag([11253e-6, 36203e-6, 42673e-6]))]
        abad_i = np.array([[381, 58, 0.45], [58, 560, 0.95], [0.45, 0.95, 444]]) * 1e-6
        # The reference expresses the hip body in a Rz(pi)-rotated frame
        # (xtreeHip, Quadruped.cpp:168-171); this model keeps all leg frames
        # axis-aligned with the abad frame, so the hip CAD inertia/CoM
        # (MiniCheetah.h:69-73) conjugate by diag(-1,-1,1): the xz/yz
        # products flip sign (xy is invariant) and the CoM x/y negate.
        hip_i = np.array([[1983, 245, -13], [245, 2103, -1.5], [-13, -1.5, 408]]) * 1e-6
        knee_i_rotated = np.diag([6e-6, 248e-6, 245e-6])
        ry = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], dtype=np.float64)
        knee_i = ry @ knee_i_rotated @ ry.T

        hips = r.hip_locations()
        for leg in range(4):
            side = r.side_signs[leg]
            base_idx = len(parents)
            # abad: at the hip mount, rotates about +X
            parents.append(0)
            x_tree.append(sp.xform(eye3, f32(hips[leg])))
            inertias.append(inertia(0.54, [0.0, side * 0.036, 0.0], _mirror_y(abad_i, side)))
            # hip: offset (0, side*l1, 0) from abad, rotates about -Y
            parents.append(base_idx)
            x_tree.append(sp.xform(eye3, f32([0.0, side * l1, 0.0])))
            # Rz(pi)-frame CoM (0, 0.016, -0.02) maps to -y here
            inertias.append(inertia(0.634, [0.0, -side * 0.016, -0.02],
                                    _mirror_y(hip_i, side)))
            # knee: offset (0,0,-l2) from hip, rotates about -Y
            parents.append(base_idx + 1)
            x_tree.append(sp.xform(eye3, f32([0.0, 0.0, -l2])))
            inertias.append(inertia(0.064, [0.0, 0.0, -0.061], _mirror_y(knee_i, side)))

        # Explicit geared rotors (MiniCheetah.h:51-109, Quadruped.cpp:117-206):
        # each moving body has a rotor attached to its PARENT at a fixed
        # translation, spinning about the joint axis at gear * q. Stored per
        # moving body: the rotor spatial inertia (mass 0.055, CoM 0, diag
        # 63e-6 spin / 33e-6 transverse: axisymmetric, so its parent-coordinate
        # static part X_rot' I_rot X_rot is CONSTANT), the parent->rotor
        # translation, and the gear ratio. Abad rotors sit on the base at
        # withLegSigns(0.125, 0.049, 0); hip rotors on the abad at
        # (0, side*0.04, 0); knee rotors at the hip origin.
        i_spin_x = np.diag([63e-6, 33e-6, 33e-6])   # abad rotors spin about X
        i_spin_y = np.diag([33e-6, 63e-6, 33e-6])   # hip/knee rotors about Y
        gears = [r.abad_gear_ratio, r.hip_gear_ratio, r.knee_gear_ratio]
        rotor_inertia, rotor_xtree = [], []
        for leg in range(4):
            side = r.side_signs[leg]
            locs = [
                [0.125 * float(np.sign(hips[leg][0])), side * 0.049, 0.0],
                [0.0, side * 0.04, 0.0],
                [0.0, 0.0, 0.0],
            ]
            for j in range(3):
                rotor_inertia.append(inertia(0.055, np.zeros(3),
                                             i_spin_x if j == 0 else i_spin_y))
                rotor_xtree.append(sp.xform(eye3, f32(locs[j])))
        self.gear = [float(gears[j % 3]) for j in range(12)]
        # the joint motion subspaces S (signed unit axes) and the geared rotor
        # subspaces Srot = sign * gear * axis, per moving body
        s_joint = torch.stack([_JOINT_SIGN[b % 3] * sp.joint_motion_subspace(
            _JOINT_AXIS[b % 3], device=cpu) for b in range(12)])
        s_rot = torch.stack([_JOINT_SIGN[b % 3] * self.gear[b] * sp.joint_motion_subspace(
            _JOINT_AXIS[b % 3], device=cpu) for b in range(12)])
        rotor_inertia = torch.stack(rotor_inertia)
        rotor_xtree = torch.stack(rotor_xtree)
        # constants exploiting rotor axisymmetry (transverse inertias equal,
        # CoM on the spin axis): Xuprot' Irot Xuprot and Xuprot' (Irot Srot)
        # are INDEPENDENT of the rotor angle, so both are precomputed here
        xt = rotor_xtree.transpose(-1, -2)
        rotor_static = xt @ rotor_inertia @ rotor_xtree
        urot_parent = _mv(xt, _mv(rotor_inertia, s_rot))

        spin = 63e-6
        consts = dict(
            x_tree=torch.stack(x_tree),                  # (13,6,6)
            inertias=torch.stack(inertias),              # (13,6,6)
            rotor_inertia=rotor_inertia,                 # (12,6,6), rotor coords
            rotor_xtree=rotor_xtree,                     # (12,6,6), parent -> rotor
            rotor_static=rotor_static,                   # (12,6,6), parent coords
            urot_parent=urot_parent,                     # (12,6), parent coords
            s_joint=s_joint,                             # (12,6)
            s_rot=s_rot,                                 # (12,6)
            # foot contact point in knee coordinates
            foot_offsets=f32([[0.0, r.side_signs[leg] * l4, -l3] for leg in range(4)]),
            # reflected rotor inertia per joint [abad, hip, knee] x 4
            rotor_refl=f32([r.abad_gear_ratio**2 * spin, r.hip_gear_ratio**2 * spin,
                            r.knee_gear_ratio**2 * spin] * 4),
            gear_t=f32(self.gear),
            # joint sign per moving body, for the joint angles theta = sign * q
            sign_t=f32([_JOINT_SIGN[b % 3] for b in range(12)]),
            eye3=eye3,
            eye6=torch.eye(6),
            zeros3=torch.zeros(3),
        )
        for name, t in consts.items():
            setattr(self, name, t.to(dev))
        self.parents = parents

    # ---------------------------------------------------------------- core
    def _joint_xforms(self, q12):
        """Per-moving-body joint transform X_J (12,6,6) and motion subspace S
        (12,6)."""
        theta = _per_leg(self.sign_t * q12)                 # (4,3)
        rot = torch.cat([sp.rot_axis(0, theta[:, 0:1]), sp.rot_axis(1, theta[:, 1:3])], dim=1)
        zero = theta.new_zeros((12, 3))
        return sp.xform(rot.reshape(12, 3, 3), zero), self.s_joint

    def _kinematics(self, q12):
        """Xup (12,6,6): transform from parent coordinates into each moving
        body's coordinates (the base's is the identity), and S."""
        xj, s = self._joint_xforms(q12)
        return xj @ self.x_tree[1:], s

    def _body_to_base(self, xup):
        """X (12,6,6) from base coordinates to each moving body's coordinates."""
        x = _per_leg(xup)
        abad = x[:, 0]
        hip = x[:, 1] @ abad
        knee = x[:, 2] @ hip
        return torch.stack([abad, hip, knee], dim=1).reshape(12, 6, 6)

    # ------------------------------------------------------------ kinematics
    def foot_positions_base(self, q12):
        """(4,3) foot positions in base coordinates (== hip offset + leg FK)."""
        xup, _ = self._kinematics(q12)
        x0 = _per_leg(self._body_to_base(xup))
        return self._point_in_base(x0[:, 2], self.foot_offsets)

    def _point_in_base(self, x0_body, point_body):
        """Transform points from body coordinates to base coordinates
        (batched over leading dims).

        For X = [[E,0],[-E px, E]] mapping base->body, a body-frame point pb
        is at E^T pb + o where o (body origin in base coords) satisfies
        -E [o]x = lower-left block => recover o from E^T and the block.
        """
        et = x0_body[..., 0:3, 0:3].transpose(-1, -2)
        skew = x0_body[..., 3:6, 0:3]            # = -E [o]x
        ox = -et @ skew                           # [o]x
        o = torch.stack([ox[..., 2, 1], ox[..., 0, 2], ox[..., 1, 0]], dim=-1)
        return o + _mv(et, point_body)

    def _rotor_xforms(self, q12):
        """Per-moving-body rotor transform Xuprot (12,6,6), parent->rotor,
        and the geared motion subspace Srot (12,6) — the reference's
        _Xuprot/_Srot (FloatingBaseModel.cpp updateArticulatedBodies)."""
        theta = _per_leg(self.sign_t * self.gear_t * q12)
        rot = torch.cat([sp.rot_axis(0, theta[:, 0:1]), sp.rot_axis(1, theta[:, 1:3])], dim=1)
        xj = sp.xform(rot.reshape(12, 3, 3), theta.new_zeros((12, 3)))
        return xj @ self.rotor_xtree, self.s_rot

    # --------------------------------------------------------------- CRBA
    def mass_matrix(self, q12):
        """Generalized mass matrix (18,18): [base(6), joints(12)], with the
        reference's exact geared-rotor terms (FloatingBaseModel.cpp:752-811):
        rotor statics in the composite recursion, gear^2 spin inertia on the
        joint diagonal, and the gear^1 coupling Xuprot'(Irot Srot) on every
        joint-ancestor column."""
        xup, s = self._kinematics(q12)
        x = _per_leg(xup)
        xt = x.transpose(-1, -2)
        s = _per_leg(s)
        ic = _per_leg(self.inertias[1:])
        rs = _per_leg(self.rotor_static)

        # composite inertias, knee -> hip -> abad -> base
        ic_knee = ic[:, 2]
        ic_hip = ic[:, 1] + xt[:, 2] @ ic_knee @ x[:, 2] + rs[:, 2]
        ic_abad = ic[:, 0] + xt[:, 1] @ ic_hip @ x[:, 1] + rs[:, 1]
        to_base = xt[:, 0] @ ic_abad @ x[:, 0]
        ic0 = self.inertias[0]
        for leg in (3, 2, 1, 0):
            ic0 = ic0 + to_base[leg] + rs[leg, 0]

        # joint-joint and joint-base terms
        icv = torch.stack([ic_abad, ic_hip, ic_knee], dim=1)          # (4,3,6,6)
        f = _mv(icv, s)                                                # (4,3,6)
        diag = _dot(s, f) + _per_leg(self.rotor_refl)                 # (4,3)
        # into parent coordinates, with the rotor gear^1 coupling
        fi = _mv(xt, f) + _per_leg(self.urot_parent)                   # (4,3,6)
        m_knee_hip = _dot(fi[:, 2], s[:, 1])
        f_knee = _mv(xt[:, 1], fi[:, 2])
        m_knee_abad = _dot(f_knee, s[:, 0])
        f_up = _mv(xt[:, 0:1], torch.stack([fi[:, 1], f_knee], dim=1))  # (4,2,6)
        m_hip_abad = _dot(fi[:, 1], s[:, 0])
        base_cols = torch.cat([fi[:, 0:1], f_up], dim=1).reshape(12, 6)

        blocks = torch.stack([
            torch.stack([diag[:, 0], m_hip_abad, m_knee_abad], dim=-1),
            torch.stack([m_hip_abad, diag[:, 1], m_knee_hip], dim=-1),
            torch.stack([m_knee_abad, m_knee_hip, diag[:, 2]], dim=-1)], dim=1)  # (4,3,3)
        joints = torch.block_diag(*blocks.unbind(0))
        return torch.cat([torch.cat([ic0, base_cols.T], dim=1),
                          torch.cat([base_cols, joints], dim=1)], dim=0)

    # --------------------------------------------------------------- RNEA
    def _backward(self, x, xrot, s, srot, f_legs, frot, f0):
        """The RNEA's inward pass: joint forces h (12,) and the base force
        (6,), from the bodies' forces f_legs (4,3,6) and the rotors' frot."""
        xt, xrott = x.transpose(-1, -2), xrot.transpose(-1, -2)
        f_knee = f_legs[:, 2]
        f_hip = f_legs[:, 1] + _mv(xt[:, 2], f_knee) + _mv(xrott[:, 2], frot[:, 2])
        f_abad = f_legs[:, 0] + _mv(xt[:, 1], f_hip) + _mv(xrott[:, 1], frot[:, 1])
        f_acc = torch.stack([f_abad, f_hip, f_knee], dim=1)
        h = _dot(s, f_acc) + _dot(srot, frot)                                    # (4,3)
        to_base = _mv(xt[:, 0], f_abad)
        to_base_rot = _mv(xrott[:, 0], frot[:, 0])
        for leg in (3, 2, 1, 0):
            f0 = f0 + to_base[leg] + to_base_rot[leg]
        return torch.cat([f0, h.reshape(12)])

    def _outward(self, x, base, inc):
        """A motion vector carried down each leg, u_i = X_i u_parent + inc_i,
        from the base's `base` (6,) and the bodies' increments `inc` (4,3,6)
        (None: none): (u (4,3,6), the parents' u (4,3,6))."""
        out, parents = [], []
        cur = base.expand(4, 6)
        for j in range(3):
            parents.append(cur)
            cur = _mv(x[:, j], cur) + (0.0 if inc is None else inc[:, j])
            out.append(cur)
        return torch.stack(out, dim=1), torch.stack(parents, dim=1)

    def bias_forces(self, q12, qd12, base_vel, gravity=9.81):
        """Generalized bias h(q, v) (Coriolis + gravity), (18,).

        base_vel: base spatial velocity [omega; v] in base coordinates.
        Gravity enters as a fictitious base acceleration (RNEA standard).
        """
        xup, s = self._kinematics(q12)
        xuprot, srot = self._rotor_xforms(q12)
        x, xrot, s, srot = _per_leg(xup), _per_leg(xuprot), _per_leg(s), _per_leg(srot)
        qd = qd12.reshape(4, 3, 1)
        a_grav = torch.cat([self.zeros3, gravity * self.eye3[2]])
        i0 = self.inertias[0]
        f0 = _mv(i0, a_grav) + _mv(sp.force_cross(base_vel), _mv(i0, base_vel))

        vj = s * qd
        v, vp = self._outward(x, base_vel, vj)
        # a_i = X_i a_p + v_i x vj_i
        a, ap = [], []
        cur = a_grav.expand(4, 6)
        for j in range(3):
            ap.append(cur)
            cur = _mv(x[:, j], cur) + _mv(sp.motion_cross(v[:, j]), vj[:, j])
            a.append(cur)
        a, ap = torch.stack(a, dim=1), torch.stack(ap, dim=1)
        ib = _per_leg(self.inertias[1:])
        f = _mv(ib, a) + _mv(sp.force_cross(v), _mv(ib, v))
        # rotor bias force (generalizedCoriolisForce's _fvprot)
        i_rot = _per_leg(self.rotor_inertia)
        vjr = srot * qd
        vrot = _mv(xrot, vp) + vjr
        arot = _mv(xrot, ap) + _mv(sp.motion_cross(vrot), vjr)
        frot = _mv(i_rot, arot) + _mv(sp.force_cross(vrot), _mv(i_rot, vrot))
        return self._backward(x, xrot, s, srot, f, frot, f0)

    def bias_forces_oriented(self, q12, qd12, base_vel, r_body, gravity=9.81):
        """bias with base orientation: gravity rotated into base coords."""
        g_base = r_body @ (gravity * self.eye3[2])
        h_flat = self.bias_forces(q12, qd12, base_vel, gravity=0.0)
        # add gravity as base acceleration: equivalent to RNEA with
        # a[0] += [0; g_base]; recompute via the linearity in a_grav:
        h_grav = self._gravity_terms(q12, g_base)
        return h_flat + h_grav

    def _gravity_terms(self, q12, g_base):
        xup, s = self._kinematics(q12)
        xuprot, srot = self._rotor_xforms(q12)
        x, xrot, s, srot = _per_leg(xup), _per_leg(xuprot), _per_leg(s), _per_leg(srot)
        a_grav = torch.cat([self.zeros3, g_base])
        f0 = _mv(self.inertias[0], a_grav)
        a, ap = self._outward(x, a_grav, None)
        f = _mv(_per_leg(self.inertias[1:]), a)
        frot = _mv(_per_leg(self.rotor_inertia), _mv(xrot, ap))
        return self._backward(x, xrot, s, srot, f, frot, f0)

    # ----------------------------------------------------- contact Jacobians
    def contact_jacobians(self, q12):
        """(4, 3, 18) foot-point Jacobians in BASE coordinates: v_foot_base =
        J [base_vel; qd]."""
        xup, s = self._kinematics(q12)
        x0 = _per_leg(self._body_to_base(xup))                        # (4,3,6,6)
        p_foot = self._point_in_base(x0[:, 2], self.foot_offsets)     # (4,3)
        # base contribution: v = v_base + omega x p
        base = torch.cat([-sp.cross_matrix(p_foot), self.eye3.expand(4, 3, 3)], dim=-1)
        # joint contributions for each leg's three joints: axis x arm, in
        # base coordinates, the arm from the joint origin to the foot
        axis_base = _mv(x0[..., 0:3, 0:3].transpose(-1, -2), _per_leg(s)[..., 0:3])
        origin = self._point_in_base(x0, self.zeros3)
        cols = torch.linalg.cross(axis_base, p_foot[:, None, :] - origin)   # (4 legs,3 joints,3)
        joints = torch.block_diag(*cols.transpose(-1, -2).unbind(0)).reshape(4, 3, 12)
        return torch.cat([base, joints], dim=-1)

    # ------------------------------------------------------ forward dynamics
    def forward_dynamics(self, q12, qd12, base_vel, tau12, r_body=None,
                         f_ext_feet=None, gravity=9.81):
        """qdd (18,) via M^-1 (tau + J^T f_ext - h).

        tau12: joint torques; f_ext_feet: optional (4,3) BASE-frame foot
        forces applied at the contact points. The solve is `solve_ex`: the
        LU solve without the host-side singularity check.
        """
        m = self.mass_matrix(q12)
        if r_body is None:
            h = self.bias_forces(q12, qd12, base_vel, gravity)
        else:
            h = self.bias_forces_oriented(q12, qd12, base_vel, r_body, gravity)
        tau = torch.cat([tau12.new_zeros(6), tau12])
        if f_ext_feet is not None:
            jac = self.contact_jacobians(q12)
            tau = tau + torch.einsum("fij,fi->j", jac, f_ext_feet)
        return torch.linalg.solve_ex(m, (tau - h)[:, None])[0][:, 0]

    # ------------------------------------------------------------------ ABA
    def aba(self, q12, qd12, base_vel, tau12, r_body=None, f_ext_feet=None,
            gravity=9.81):
        """Articulated-Body Algorithm: O(n) forward dynamics with a 6-DoF
        floating base (the reference's runABA, FloatingBaseModel.cpp:879-958).

        Same qdd (18,) as `forward_dynamics`; gravity and external foot
        forces enter as per-body external spatial forces, and the geared
        rotors carry the reference's exact recursion terms (Utot/d/u with
        Srot couplings)."""
        xup, s = self._kinematics(q12)
        x0 = _per_leg(self._body_to_base(xup))
        xuprot, srot = self._rotor_xforms(q12)
        x, xrot, s, srot = _per_leg(xup), _per_leg(xuprot), _per_leg(s), _per_leg(srot)
        xt, xrott = x.transpose(-1, -2), xrot.transpose(-1, -2)
        qd = qd12.reshape(4, 3, 1)
        tau = tau12.reshape(4, 3)
        g_world = -gravity * self.eye3[2]
        g_base = g_world if r_body is None else r_body @ g_world
        a_grav = torch.cat([self.zeros3, g_base])
        i0 = self.inertias[0]
        ib = _per_leg(self.inertias[1:])
        i_rot = _per_leg(self.rotor_inertia)

        # pass 1: velocities, velocity-product accelerations, bias forces
        # (gravity as the external force I_i X_{0->i} a_grav on every body,
        # and likewise -Irot X_{0->rot} a_grav on every rotor)
        vj = s * qd
        v, vp = self._outward(x, base_vel, vj)
        c = _mv(sp.motion_cross(v), vj)
        pa = _mv(sp.force_cross(v), _mv(ib, v)) - _mv(ib, _mv(x0, a_grav))
        if f_ext_feet is not None:
            e = x0[:, 2, 0:3, 0:3]                         # base -> knee rotation
            f_knee = _mv(e, f_ext_feet)                     # force in knee coords
            fext = torch.cat([torch.linalg.cross(self.foot_offsets, f_knee), f_knee], dim=-1)
            pa = torch.cat([pa[:, 0:2], (pa[:, 2] - fext)[:, None]], dim=1)
        pa0 = _mv(sp.force_cross(base_vel), _mv(i0, base_vel)) - _mv(i0, a_grav)
        vjr = srot * qd
        vrot = _mv(xrot, vp) + vjr
        crot = _mv(sp.motion_cross(vrot), vjr)
        x0p = torch.cat([self.eye6.expand(4, 1, 6, 6), x0[:, 0:2]], dim=1)   # parents' X
        parot = (_mv(sp.force_cross(vrot), _mv(i_rot, vrot))
                 - _mv(i_rot, _mv(xrot, _mv(x0p, a_grav))))

        # pass 2: articulated-body inertias inward (reference
        # updateArticulatedBodies + runABA loop 2, rotor-exact)
        urot = _mv(i_rot, srot)                              # (4,3,6)
        rs = _per_leg(self.rotor_static)
        ia_j, pa_j = ib[:, 2], pa[:, 2]
        utot_l, d_l, usc_l = [None] * 3, [None] * 3, [None] * 3
        for j in (2, 1, 0):
            u = _mv(ia_j, s[:, j])
            utot = _mv(xt[:, j], u) + _per_leg(self.urot_parent)[:, j]      # parent coords
            d = _dot(s[:, j], u) + _dot(srot[:, j], urot[:, j])
            usc = (tau[:, j] - _dot(s[:, j], pa_j) - _dot(srot[:, j], parot[:, j])
                   - _dot(u, c[:, j]) - _dot(urot[:, j], crot[:, j]))
            ia_x = xt[:, j] @ ia_j @ x[:, j]
            ia_u = utot[:, :, None] * utot[:, None, :] / d[:, None, None]
            pa_x = _mv(xt[:, j], pa_j + _mv(ia_j, c[:, j]))
            pa_rot = _mv(xrott[:, j], parot[:, j] + _mv(i_rot[:, j], crot[:, j]))
            pa_u = utot * (usc / d)[:, None]
            utot_l[j], d_l[j], usc_l[j] = utot, 1.0 / d, usc
            if j > 0:
                ia_j = ib[:, j - 1] + ia_x + rs[:, j] - ia_u
                pa_j = pa[:, j - 1] + pa_x + pa_rot + pa_u
        ia0 = i0
        for leg in (3, 2, 1, 0):
            ia0 = ia0 + ia_x[leg] + rs[leg, 0] - ia_u[leg]
            pa0 = pa0 + pa_x[leg] + pa_rot[leg] + pa_u[leg]

        # pass 3: accelerations outward
        a0 = torch.linalg.solve_ex(ia0, -pa0[:, None])[0][:, 0]
        ap = a0.expand(4, 6)
        qdd = []
        for j in range(3):
            qdd_j = (usc_l[j] - _dot(utot_l[j], ap)) * d_l[j]
            ap = _mv(x[:, j], ap) + s[:, j] * qdd_j[:, None] + c[:, j]
            qdd.append(qdd_j)
        return torch.cat([a0, torch.stack(qdd, dim=1).reshape(12)])

    # -------------------------------------- operational-space contact tools
    def inv_contact_inertia(self, q12):
        """(12,12) inverse operational-space inertia Lambda^-1 = J M^-1 J^T
        over all four foot contact points (3 rows each) — the reference's
        invContactInertia (FloatingBaseModel.cpp:1061-1106). The (4,3,3)
        per-foot blocks are the diagonal; off-diagonal blocks give
        inter-foot coupling."""
        m = self.mass_matrix(q12)
        jac = self.contact_jacobians(q12).reshape(12, N_DOF)
        minv_jt = torch.linalg.solve_ex(m, jac.T)[0]            # (18,12)
        return jac @ minv_jt

    def apply_test_force(self, q12, leg: int, force_base):
        """Response to a test force at foot `leg` (reference applyTestForce,
        FloatingBaseModel.cpp:961-1050): returns (delta_v_foot (3,),
        delta_qd (18,)) per unit impulse — dv_foot = J_leg M^-1 J_leg^T f,
        dqd = M^-1 J_leg^T f."""
        m = self.mass_matrix(q12)
        jac = self.contact_jacobians(q12)[leg]                    # (3,18)
        dqd = torch.linalg.solve_ex(m, (jac.T @ force_base)[:, None])[0][:, 0]
        return jac @ dqd, dqd

    # ------------------------------------------------- body-box contact set
    def box_contact_points(self):
        """(8,3) body-box corner contact points in base coordinates
        (reference addGroundContactBoxPoints, FloatingBaseModel.cpp:360-376,
        with dims (bodyLength, bodyWidth, bodyHeight), Quadruped.cpp:123-128)."""
        r = self.robot
        l, w, h = r.body_length, r.body_width, r.body_height
        corners = np.array(
            [[sx * l, sy * w, sz * h]
             for sz in (1.0, -1.0) for sy in (1.0, -1.0) for sx in (1.0, -1.0)],
            dtype=np.float32,
        ) / 2.0
        return _device.constant(corners, self.device)

    def box_point_jacobians(self):
        """(8,3,18) Jacobians of the box corner points (base body: base-rate
        columns only — v_p = v_base + omega x p, no joint contribution)."""
        pts = self.box_contact_points()
        return torch.cat([-sp.cross_matrix(pts), self.eye3.expand(8, 3, 3),
                          pts.new_zeros((8, 3, 12))], dim=-1)

    def box_point_positions_world(self, base_p, r_body):
        """(8,3) world positions of the box corners; r_body maps world->base
        (StateEstimate.r_body convention)."""
        pts = self.box_contact_points()
        return base_p[None, :] + torch.einsum("ij,ki->kj", r_body, pts)
