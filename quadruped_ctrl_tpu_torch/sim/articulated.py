"""Articulated whole-robot simulation (18-DoF Featherstone + penalty contact).

The counterpart of `quadruped_ctrl_tpu/sim/articulated.py`: the
full-fidelity counterpart of the SRB scenario engine. Joint torques from the
controller drive the actual rigid-body dynamics (CRBA/RNEA forward dynamics
+ actuator saturation), feet make ground contact through a spring-damper
penalty with a Coulomb friction cap — the role PyBullet plays for the
reference (walking_simulation.py:224-244). The JAX package's `lax.scan`s are
Python loops here.

Semi-implicit Euler with substeps keeps the stiff contact stable at the
500 Hz control rate.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import FrameworkConfig
from quadruped_ctrl_tpu_torch.control import controller as ctrl
from quadruped_ctrl_tpu_torch.core import rotations as rot
from quadruped_ctrl_tpu_torch.core.precision import exact_matmuls
from quadruped_ctrl_tpu_torch.core.types import Sensors, Tree, tree_map
from quadruped_ctrl_tpu_torch.models import actuator
from quadruped_ctrl_tpu_torch.models.floating_base import MiniCheetahModel
from quadruped_ctrl_tpu_torch.sim.engine import CROUCH_Q
from quadruped_ctrl_tpu_torch.sim.rollout import WARMUP_TICKS, make_command_sequence
from quadruped_ctrl_tpu_torch.sim.terrain import Terrain, height_at


@dataclasses.dataclass(frozen=True)
class ArticulatedState(Tree):
    p: torch.Tensor           # (3,) base position, world
    quat: torch.Tensor        # (4,) (w,x,y,z) body->world
    base_vel: torch.Tensor    # (6,) spatial [omega; v] in base coords
    q: torch.Tensor           # (12,)
    qd: torch.Tensor          # (12,)
    prev_v_world: torch.Tensor  # (3,) for accelerometer synthesis


def articulated_init(cfg: FrameworkConfig, model: MiniCheetahModel,
                     terrain: Terrain, device=None) -> ArticulatedState:
    """The crouch pose with the lowest foot 2 mm above z = 0, on `device`
    (cuda:0 unless named; the model lies there)."""
    dev = _device.resolve(device)
    q = _device.constant(CROUCH_Q, dev).repeat(4)
    feet = model.foot_positions_base(q)
    base_z = -torch.amin(feet[:, 2]) + 0.002
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return ArticulatedState(
        p=torch.stack([zero, zero, base_z]),
        quat=_device.constant([1.0, 0.0, 0.0, 0.0], dev),
        base_vel=torch.zeros(6, dtype=torch.float32, device=dev),
        q=q,
        qd=torch.zeros(12, dtype=torch.float32, device=dev),
        prev_v_world=torch.zeros(3, dtype=torch.float32, device=dev),
    )


@exact_matmuls
def sensors_from_articulated(cfg: FrameworkConfig, st: ArticulatedState) -> Sensors:
    r = rot.quat_to_rot(st.quat)          # body->world
    v_world = r @ st.base_vel[3:6]
    accel_world = (v_world - st.prev_v_world) / cfg.dt + _device.constant(
        [0.0, 0.0, 9.8], st.p.device)
    accel_body = r.T @ accel_world
    quat_xyzw = torch.stack([st.quat[1], st.quat[2], st.quat[3], st.quat[0]])
    return Sensors(
        quat=quat_xyzw,
        gyro=st.base_vel[0:3],
        accelerometer=accel_body,
        q=st.q,
        qd=st.qd,
    )


def _contact_forces(cfg: FrameworkConfig, model, st: ArticulatedState,
                    terrain: Terrain, r):
    """World-frame penalty contact forces at the 4 feet. Returns (f_world
    (4,3), feet_world (4,3))."""
    feet_base = model.foot_positions_base(st.q)
    feet_world = st.p[None, :] + torch.einsum("ij,fj->fi", r, feet_base)
    jac = model.contact_jacobians(st.q)                      # (4,3,18), base
    gen_vel = torch.cat([st.base_vel, st.qd])
    v_feet_base = torch.einsum("fij,j->fi", jac, gen_vel)
    v_feet_world = torch.einsum("ij,fj->fi", r, v_feet_base)

    ground = height_at(terrain, feet_world[:, 0], feet_world[:, 1])
    depth = ground - feet_world[:, 2]                        # >0 => penetrating
    in_contact = depth > 0.0

    kp, kd = cfg.sim.ground_kp, cfg.sim.ground_kd
    fz = torch.where(
        in_contact,
        torch.clamp(kp * depth - kd * v_feet_world[:, 2], min=0.0),
        0.0,
    )
    kt = 800.0
    ft = -kt * v_feet_world[:, 0:2]
    cap = cfg.sim.mu * fz
    ft_norm = torch.linalg.vector_norm(ft, dim=1)
    scale = torch.where(ft_norm > cap, cap / torch.clamp(ft_norm, min=1e-9), 1.0)
    ft = ft * (scale * in_contact)[:, None]
    f_world = torch.cat([ft, fz[:, None]], dim=1)
    return f_world, feet_world


@exact_matmuls
def articulated_step(cfg: FrameworkConfig, model: MiniCheetahModel,
                     st: ArticulatedState, tau_cmd, terrain: Terrain,
                     substeps: int = 4) -> ArticulatedState:
    """One control tick (cfg.dt) of full dynamics under commanded torques."""
    h = cfg.dt / substeps
    tau = actuator.achievable_torque(cfg.robot, tau_cmd, st.qd)
    prev_v_world = rot.quat_to_rot(st.quat) @ st.base_vel[3:6]

    for _ in range(substeps):
        r = rot.quat_to_rot(st.quat)
        r_body = r.T
        f_world, _ = _contact_forces(cfg, model, st, terrain, r)
        f_base = torch.einsum("ij,fj->fi", r_body, f_world)
        qdd = model.forward_dynamics(
            st.q, st.qd, st.base_vel, tau, r_body=r_body, f_ext_feet=f_base,
            gravity=cfg.sim.gravity,
        )
        base_vel = st.base_vel + h * qdd[0:6]
        qd = st.qd + h * qdd[6:18]
        q = st.q + h * qd
        quat = rot.quat_integrate(st.quat, base_vel[0:3], h)
        p = st.p + h * (rot.quat_to_rot(quat) @ base_vel[3:6])
        st = st.replace(p=p, quat=quat, base_vel=base_vel, q=q, qd=qd)
    return st.replace(prev_v_world=prev_v_world)


@exact_matmuls
def run_articulated_session(cfg: FrameworkConfig, terrain: Terrain,
                            cmd, n_ticks: int, stand_ticks: int = 400,
                            model: MiniCheetahModel | None = None,
                            mpc_iterations: int | None = None, device=None):
    """Closed-loop session on full dynamics (stand phase, then `cmd`), on
    `device` (cuda:0 unless named; the terrain, the command and the model
    lie there).

    Returns (controller_state, sim_state, traj dict) like sim.rollout but
    driven through joint torques + actuator saturation + penalty contact.
    Each tick's record stays on the device; the records are stacked once at
    the end.
    """
    dev = _device.resolve(device)
    model = model or MiniCheetahModel(device=dev)
    sim = articulated_init(cfg, model, terrain, device=dev)
    state = ctrl.init_state(cfg, device=dev)
    for _ in range(WARMUP_TICKS):
        state = ctrl.pre_work(cfg, state, sensors_from_articulated(cfg, sim))

    cmds = make_command_sequence(cfg, n_ticks, cmd, stand_ticks=stand_ticks)
    recs = []
    for i in range(n_ticks):
        sens = sensors_from_articulated(cfg, sim)
        state, out = ctrl.controller_step(cfg, state, sens, tree_map(lambda t: t[i], cmds),
                                          mpc_iterations=mpc_iterations)
        sim = articulated_step(cfg, model, sim, out.tau, terrain)
        r = rot.quat_to_rot(sim.quat)
        recs.append(dict(
            p=sim.p,
            v=r @ sim.base_vel[3:6],
            rpy=rot.quat_to_rpy(sim.quat),
            tau=out.tau,
            safety=state.core.safety_ok,
        ))
    return state, sim, {k: torch.stack([rec[k] for rec in recs]) for k in recs[0]}
