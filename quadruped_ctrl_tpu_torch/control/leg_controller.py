"""Leg-level data update and torque mapping.

The counterpart of `quadruped_ctrl_tpu/control/leg_controller.py`, a
re-derivation of LegController (reference
Controllers/LegController.cpp:89-188): `update_data` computes per-leg
FK/Jacobian/foot velocity from joint sensors; `update_command` maps
cartesian-space commands to joint torques:

    tau = J' (f_ff + Kp_cart (pDes - p) + Kd_cart (vDes - v)) + tau_ff
          + joint_kp (0 - q) - joint_kd qd

(the joint-space PD toward q=0 uses ctrlParam(2,3); the reference's per-leg
"1*" factors on legs 1,3 are identity and intentionally not reproduced).
"""

from __future__ import annotations

import torch

from quadruped_ctrl_tpu_torch.config import ControlConfig, RobotConfig
from quadruped_ctrl_tpu_torch.core.types import LegData
from quadruped_ctrl_tpu_torch.models import leg_kinematics as lk


def update_data(robot: RobotConfig, q12, qd12) -> LegData:
    """Joint sensor vectors (12,) -> per-leg kinematic data (LegController.cpp:89-108)."""
    q = q12.reshape(4, 3)
    qd = qd12.reshape(4, 3)
    jac = lk.leg_jacobian(robot, q)
    p = lk.leg_fk(robot, q)
    v = lk.foot_velocity(jac, qd)
    return LegData(q=q, qd=qd, p=p, v=v, jac=jac)


def update_command(
    ctrl: ControlConfig,
    data: LegData,
    p_des,            # (4,3) desired foot position, hip frame
    v_des,            # (4,3) desired foot velocity, hip frame
    kp_cartesian,     # (4,3) diagonal gains per leg
    kd_cartesian,     # (4,3)
    force_ff,         # (4,3) feedforward foot force, body frame
    tau_ff=None,      # (4,3)
):
    """Returns joint torques (12,) (LegController.cpp:113-155)."""
    foot_force = (
        force_ff
        + kp_cartesian * (p_des - data.p)
        + kd_cartesian * (v_des - data.v)
    )
    leg_torque = torch.einsum("fji,fj->fi", data.jac, foot_force)
    if tau_ff is not None:
        leg_torque = leg_torque + tau_ff
    tau = ctrl.joint_kp * (0.0 - data.q) - ctrl.joint_kd * data.qd + leg_torque
    return tau.reshape(12)
