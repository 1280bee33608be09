"""VectorNav-style orientation estimator.

The counterpart of `quadruped_ctrl_tpu/estimation/orientation.py`, a
re-derivation of VectorNavOrientationEstimator (reference
Controllers/OrientationEstimator.cpp:45-110): reorders the (x,y,z,w) sensor
quaternion to (w,x,y,z), removes the initial yaw on first visit, and derives
rpy / rBody / omega / acceleration in both frames.
"""

from __future__ import annotations

import torch

from quadruped_ctrl_tpu_torch.core import rotations as rot
from quadruped_ctrl_tpu_torch.core.types import EstimatorState, Sensors


def run(state: EstimatorState, sensors: Sensors):
    """Returns (new_state, dict of orientation-block estimate fields)."""
    q_xyzw = sensors.quat
    q = torch.stack([q_xyzw[3], q_xyzw[0], q_xyzw[1], q_xyzw[2]])  # -> (w,x,y,z)

    rpy_ini = rot.quat_to_rpy(q)
    zero = torch.zeros_like(rpy_ini[2])
    rpy_ini = torch.stack([zero, zero, rpy_ini[2]])
    ori_ini_inv_new = rot.rpy_to_quat(-rpy_ini)
    ori_ini_inv = torch.where(state.first_visit, ori_ini_inv_new, state.ori_ini_inv)

    orientation = rot.quat_product(ori_ini_inv, q)
    rpy = rot.quat_to_rpy(orientation)
    r_body = rot.quat_to_rbody(orientation)
    omega_body = sensors.gyro
    omega_world = r_body.T @ omega_body
    a_body = sensors.accelerometer
    a_world = r_body.T @ a_body

    new_state = state.replace(ori_ini_inv=ori_ini_inv,
                              first_visit=torch.zeros_like(state.first_visit))
    return new_state, dict(
        orientation=orientation,
        rpy=rpy,
        r_body=r_body,
        omega_body=omega_body,
        omega_world=omega_world,
        a_body=a_body,
        a_world=a_world,
    )
