"""Desired-state command filter.

The counterpart of `quadruped_ctrl_tpu/control/desired_state.py`, a
re-derivation of DesiredStateCommand (reference
Controllers/DesiredStateCommand.cpp:24-149, DesiredStateCommand.h:77-122):
low-pass filters the analog sticks (filter = 0.1), applies a 0.075 deadband
with range scaling, and assembles the 12-dim desired state. Like the
reference, this runs every tick but ConvexMPC reads the raw gamepad command
directly — it is kept for API parity and external consumers.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.core.types import Tree


@dataclasses.dataclass(frozen=True)
class DesiredStateCommandState(Tree):
    left_stick: torch.Tensor    # (2,)
    right_stick: torch.Tensor   # (2,)

    @staticmethod
    def create(device=None):
        dev = _device.resolve(device)
        return DesiredStateCommandState(
            left_stick=torch.zeros(2, dtype=torch.float32, device=dev),
            right_stick=torch.zeros(2, dtype=torch.float32, device=dev),
        )


_FILTER = 0.1
_DEADBAND = 0.075
_MIN_VEL_X, _MAX_VEL_X = -3.0, 3.0
_MIN_VEL_Y, _MAX_VEL_Y = -2.0, 2.0
_MIN_TURN, _MAX_TURN = -2.5, 2.5
_MIN_PITCH, _MAX_PITCH = -0.4, 0.4


def _deadband(command, lo, hi):
    return torch.where(command.abs() < _DEADBAND, 0.0, command * 0.5 * (hi - lo))


def convert_to_state_commands(state: DesiredStateCommandState, gamepad, dt):
    """gamepad: (4,) [vx, vy, wz, pitch]. Returns (state, state_des (12,))."""
    left = torch.stack([-gamepad[0], gamepad[1]])
    right = torch.stack([-gamepad[2], gamepad[3]])
    left_f = state.left_stick * (1.0 - _FILTER) + left * _FILTER
    right_f = state.right_stick * (1.0 - _FILTER) + right * _FILTER

    vx = _deadband(left_f[1], _MIN_VEL_X, _MAX_VEL_X)
    vy = _deadband(left_f[0], _MIN_VEL_Y, _MAX_VEL_Y)
    wz = _deadband(right_f[0], _MIN_TURN, _MAX_TURN)
    pitch = _deadband(right_f[1], _MIN_PITCH, _MAX_PITCH)
    zero = torch.zeros_like(vx)
    des = torch.stack([dt * vx, dt * vy, zero + 0.26, zero, pitch, dt * wz,
                       vx, vy, zero, zero, zero, wz])
    return (
        DesiredStateCommandState(left_stick=left_f, right_stick=right_f),
        des,
    )


def desired_state_trajectory(state_des, dt_vec):
    """Linear desired-state extrapolation over N future steps.

    Re-derivation of DesiredStateCommand::desiredStateTrajectory
    (DesiredStateCommand.cpp:106-160; defined but never called from the
    reference's run path). state_des: (12,), dt_vec: (N,) per-step dts.
    Returns (N, 12) with positions/angles integrated by their rates.
    """
    eye = torch.eye(12, dtype=state_des.dtype, device=state_des.device)
    rate = torch.zeros_like(eye)
    rate[:6, 6:] = torch.eye(6, dtype=state_des.dtype, device=state_des.device)
    s = state_des
    traj = []
    for i in range(dt_vec.shape[0]):
        s = (eye + dt_vec[i] * rate) @ s
        traj.append(s)
    return torch.stack(traj)
