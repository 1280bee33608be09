"""Actuator (motor electrical) model.

The counterpart of `quadruped_ctrl_tpu/models/actuator.py`, a re-derivation
of the reference's ActuatorModel (src/Dynamics/ActuatorModel.h:54-71):
torque command -> motor current -> battery-voltage clamp -> achievable
torque, minus dry + viscous friction. Vectorized over all 12 joints; used by
the articulated simulation to saturate commanded torques.
"""

from __future__ import annotations

import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import RobotConfig


def gear_ratios(robot: RobotConfig, device=None):
    """(12,) gear ratios [abad, hip, knee] x 4, on `device` (cuda:0 unless
    named)."""
    return _device.constant(
        [robot.abad_gear_ratio, robot.hip_gear_ratio, robot.knee_gear_ratio] * 4,
        _device.resolve(device))


def achievable_torque(robot: RobotConfig, tau_des, qd):
    """tau_des, qd: (12,) joint-space command and velocity -> (12,) torque.

    Mirrors ActuatorModel::getTorque: current from desired torque, clamp by
    what the battery voltage allows at this speed (back-EMF), clamp by the
    max motor torque, then subtract friction.
    """
    g = gear_ratios(robot, device=tau_des.device)
    kt = robot.motor_kt
    r = robot.motor_r
    v_max = robot.battery_v
    tau_motor_max = robot.motor_tau_max

    tau_des_motor = tau_des / g                 # motor-side desired torque
    i_des = tau_des_motor / (kt * 1.5)          # q-axis current
    bemf = qd * g * kt * 2.0                    # back EMF voltage
    v_avail_pos = v_max - bemf
    v_avail_neg = -v_max - bemf
    i_max_pos = v_avail_pos / r
    i_max_neg = v_avail_neg / r
    i_act = torch.clamp(i_des, i_max_neg, i_max_pos)
    tau_motor = torch.clamp(kt * 1.5 * i_act, -tau_motor_max, tau_motor_max)
    tau_joint = tau_motor * g

    friction = (
        robot.joint_damping * qd
        + robot.joint_dry_friction * torch.tanh(qd / 0.1)
    )
    return tau_joint - friction
