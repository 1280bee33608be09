"""Cheater (ground-truth pass-through) estimators.

The counterpart of `quadruped_ctrl_tpu/estimation/cheater.py`, a
re-derivation of CheaterOrientationEstimator /
CheaterPositionVelocityEstimator (reference
Controllers/OrientationEstimator.cpp:21-39,
PositionVelocityEstimator.cpp:229-241; registered only when cheater_mode,
which the reference never enables): bypass the sensor pipeline with
simulator ground truth — useful for isolating controller behavior from
estimation error in closed-loop studies.
"""

from __future__ import annotations

from quadruped_ctrl_tpu_torch.core import rotations as rot
from quadruped_ctrl_tpu_torch.core.types import StateEstimate


def cheater_estimate(position, quat_wxyz, v_world, omega_body,
                     a_body=None, contact_phase=None) -> StateEstimate:
    """Build a StateEstimate directly from ground truth, where `position`
    lies."""
    r_body = rot.quat_to_rbody(quat_wxyz)
    a_body = position.new_zeros(3) if a_body is None else a_body
    contact = position.new_full((4,), 0.5) if contact_phase is None else contact_phase
    return StateEstimate(
        position=position,
        v_world=v_world,
        v_body=r_body @ v_world,
        orientation=quat_wxyz,
        r_body=r_body,
        rpy=rot.quat_to_rpy(quat_wxyz),
        omega_body=omega_body,
        omega_world=r_body.T @ omega_body,
        a_body=a_body,
        a_world=r_body.T @ a_body,
        contact_estimate=contact,
    )
