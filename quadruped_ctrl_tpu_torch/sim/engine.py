"""Batched single-rigid-body + point-foot scenario simulator.

The counterpart of `quadruped_ctrl_tpu/sim/engine.py`, the replacement for
the reference's PyBullet front-end (scripts/walking_simulation.py): a pure
physics step over a state tree, so thousands of (terrain x gait x velocity)
scenarios run under `torch.func.vmap`. Physics model:

* the body is the SRB the MPC assumes (mass 9, I = diag(0.07,0.26,0.242));
* stance feet are pinned where they touched down and transmit the
  controller's commanded ground-reaction forces when in contact with the
  terrain ("perfect force tracking");
* swing feet kinematically track the controller's swing trajectory;
* joint positions/velocities are synthesized from foot targets via leg IK
  (knee-forward branch, the robot's crouch configuration);
* the IMU is synthesized like the reference sim does from ground truth
  (body-frame gyro, finite-difference accelerometer + 9.8 bias,
  walking_simulation.py:536-558).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import FrameworkConfig
from quadruped_ctrl_tpu_torch.core import rotations as rot
from quadruped_ctrl_tpu_torch.core.precision import exact_matmuls
from quadruped_ctrl_tpu_torch.core.types import ControllerOutput, Sensors, Tree
from quadruped_ctrl_tpu_torch.models import leg_kinematics as lk
from quadruped_ctrl_tpu_torch.sim.terrain import Terrain, height_at

CROUCH_Q = np.array([0.0, -0.8, 1.6], np.float32)  # walking_simulation.py:35


@dataclasses.dataclass(frozen=True)
class SimState(Tree):
    p: torch.Tensor           # (3,) base position, world
    quat: torch.Tensor        # (4,) (w,x,y,z), body->world
    v: torch.Tensor           # (3,) base velocity, world
    omega_body: torch.Tensor  # (3,)
    foot_pos: torch.Tensor    # (4,3) actual foot positions, world
    foot_vel: torch.Tensor    # (4,3) actual foot velocities, world
    in_contact: torch.Tensor  # (4,) bool
    prev_v: torch.Tensor      # (3,) for accelerometer synthesis


def sim_init(cfg: FrameworkConfig, terrain: Terrain, device=None) -> SimState:
    """Crouch pose with feet on the terrain (the reference drops from 0.30 m;
    the state starts settled to avoid the impact transient the SRB model
    can't represent), on `device` (cuda:0 unless named; the terrain lies
    there too)."""
    dev = _device.resolve(device)
    q = _device.constant(np.tile(CROUCH_Q, (4, 1)), dev)
    foot_hip = lk.leg_fk(cfg.robot, q)                      # (4,3) hip frame
    foot_body = _device.constant(cfg.robot.hip_locations(), dev) + foot_hip
    base_z = -torch.amin(foot_body[:, 2])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    p = torch.stack([zero, zero, base_z])
    foot_w = p[None, :] + foot_body
    ground = height_at(terrain, foot_w[:, 0], foot_w[:, 1])
    foot_w = torch.cat([foot_w[:, :2], ground[:, None]], dim=1)
    return SimState(
        p=p,
        quat=_device.constant([1.0, 0.0, 0.0, 0.0], dev),
        v=torch.zeros(3, dtype=torch.float32, device=dev),
        omega_body=torch.zeros(3, dtype=torch.float32, device=dev),
        foot_pos=foot_w,
        foot_vel=torch.zeros((4, 3), dtype=torch.float32, device=dev),
        in_contact=torch.ones(4, dtype=torch.bool, device=dev),
        prev_v=torch.zeros(3, dtype=torch.float32, device=dev),
    )


@exact_matmuls
def sensors_from_sim(cfg: FrameworkConfig, sim: SimState) -> Sensors:
    """Synthesize the reference's imu_data[10] + leg_data[24]
    (walking_simulation.py:521-573)."""
    dev = sim.p.device
    r = rot.quat_to_rot(sim.quat)        # body->world
    r_inv = r.T
    dt = cfg.dt
    accel_world = (sim.v - sim.prev_v) / dt + _device.constant([0.0, 0.0, 9.8], dev)
    accel_body = r_inv @ accel_world

    hips = _device.constant(cfg.robot.hip_locations(), dev)
    p_leg = torch.einsum("ij,fj->fi", r_inv, sim.foot_pos - sim.p[None, :]) - hips
    q = lk.leg_ik(cfg.robot, p_leg)
    jac = lk.leg_jacobian(cfg.robot, q)
    v_leg = (
        torch.einsum("ij,fj->fi", r_inv, sim.foot_vel - sim.v[None, :])
        - torch.linalg.cross(sim.omega_body.expand(4, 3), hips + p_leg)
    )
    # damped least-squares J qd = v: the plain solve is singular at knee
    # full extension; lambda=1e-3 is invisible at nominal configurations and
    # bounds qd near the singularity instead of emitting inf/NaN. solve_ex:
    # the LU solve without the error check, which would wait on the device
    lam2 = 1e-6
    jjt = torch.einsum("fij,fkj->fik", jac, jac) + lam2 * torch.eye(3, device=dev)[None]
    qd = torch.einsum("fji,fj->fi", jac,
                      torch.linalg.solve_ex(jjt, v_leg[..., None])[0][..., 0])

    quat_xyzw = torch.stack([sim.quat[1], sim.quat[2], sim.quat[3], sim.quat[0]])
    return Sensors(
        quat=quat_xyzw,
        gyro=sim.omega_body,
        accelerometer=accel_body,
        q=q.reshape(12),
        qd=qd.reshape(12),
    )


@exact_matmuls
def sim_step(cfg: FrameworkConfig, sim: SimState, out: ControllerOutput,
             terrain: Terrain) -> SimState:
    """One physics tick driven by the controller output."""
    dev = sim.p.device
    dt = cfg.dt
    m = cfg.mpc.mass
    i_diag = _device.constant(np.diagonal(cfg.mpc.inertia_arr()), dev)
    r = rot.quat_to_rot(sim.quat)        # body->world
    g = _device.constant([0.0, 0.0, -cfg.sim.gravity], dev)

    in_stance = out.contact_state > 0.0

    # feet: swing feet track the commanded trajectory; stance feet stay put
    ground_sw = height_at(terrain, out.p_foot_des[:, 0], out.p_foot_des[:, 1])
    p_sw = torch.cat([out.p_foot_des[:, :2],
                      torch.maximum(out.p_foot_des[:, 2], ground_sw)[:, None]], dim=1)
    foot_pos = torch.where(in_stance[:, None], sim.foot_pos, p_sw)
    foot_vel = torch.where(in_stance[:, None], 0.0, out.v_foot_des)

    # contact requires the foot to actually reach the terrain
    ground = height_at(terrain, foot_pos[:, 0], foot_pos[:, 1])
    touching = foot_pos[:, 2] <= ground + 5e-3
    active = in_stance & touching

    forces = torch.where(active[:, None], out.fr_des, 0.0)   # (4,3) world GRFs
    f_total = torch.sum(forces, dim=0) + m * g
    torque_world = torch.sum(torch.linalg.cross(sim.foot_pos - sim.p[None, :], forces), dim=0)
    torque_body = r.T @ torque_world

    v_new = sim.v + dt * f_total / m
    p_new = sim.p + dt * v_new
    omega_dot = (torque_body - torch.linalg.cross(sim.omega_body, i_diag * sim.omega_body)
                 ) / i_diag
    omega_new = sim.omega_body + dt * omega_dot
    quat_new = rot.quat_integrate(sim.quat, omega_new, dt)

    return SimState(
        p=p_new,
        quat=quat_new,
        v=v_new,
        omega_body=omega_new,
        foot_pos=foot_pos,
        foot_vel=foot_vel,
        in_contact=active,
        prev_v=sim.v,
    )
