"""The MPC reference trajectory.

The counterpart of `quadruped_ctrl_tpu/mpc/reference.py`, a re-derivation of
the trajAll construction in ConvexMPCLocomotion::updateMPCIfNeeded
(reference ConvexMPCLocomotion.cpp:498-590): standing holds the captured
pose; otherwise start from the desired world position (clamped to +-0.1 m of
the actual) and integrate the desired world velocity / yaw rate forward per
MPC step.

Returns (h_max, 13) — the 12 reference entries plus the zero gravity-state
column — and the (possibly clamped) world_position_desired.
"""

from __future__ import annotations

import torch

from quadruped_ctrl_tpu_torch.config import FrameworkConfig


def build_reference(
    cfg: FrameworkConfig,
    standing,                  # () bool: current_gait == 4
    stand_traj,                # (6,) [x,y,z,r,p,yaw]
    world_position_desired,    # (3,)
    position,                  # (3,) estimated
    rpy_comp,                  # (3,) [roll_comp, pitch_comp, -]
    yaw_des_true,              # ()
    yaw_turn_rate,             # ()
    v_des_world,               # (3,)
    h_max: int,
):
    dtype, dev = position.dtype, position.device
    dt_mpc = cfg.dt_mpc
    max_err = 0.1

    x_start = torch.clamp(world_position_desired[0], position[0] - max_err,
                          position[0] + max_err)
    y_start = torch.clamp(world_position_desired[1], position[1] - max_err,
                          position[1] + max_err)
    wpd = torch.stack([x_start, y_start, world_position_desired[2]])

    steps = torch.arange(h_max, dtype=dtype, device=dev)
    zero = torch.zeros((h_max,), dtype=dtype, device=dev)
    height = torch.full((h_max,), cfg.control.body_height, dtype=dtype, device=dev)

    def col(v):
        return zero + v

    # moving branch (lines 533-577): step 0 holds, then integrates
    mv = torch.stack([
        col(rpy_comp[0]), col(rpy_comp[1]),
        yaw_des_true + steps * dt_mpc * yaw_turn_rate,
        x_start + steps * dt_mpc * v_des_world[0],
        y_start + steps * dt_mpc * v_des_world[1],
        height, zero, zero,
        col(yaw_turn_rate), col(v_des_world[0]), col(v_des_world[1]),
        zero, zero,
    ], dim=-1)

    # standing branch (lines 514-531)
    st = torch.stack([
        zero, zero, col(stand_traj[5]), col(stand_traj[0]), col(stand_traj[1]),
        height, zero, zero, zero, zero, zero, zero, zero,
    ], dim=-1)

    traj = torch.where(standing, st, mv)
    wpd = torch.where(standing, world_position_desired, wpd)
    return traj, wpd
