"""Closed-loop rollouts: controller + SRB sim, one robot.

The counterpart of `quadruped_ctrl_tpu/sim/rollout.py`. Replicates the
reference's session structure (walking_simulation.py:170-198): 10 estimator
warm-up ticks, a 200-tick stand phase in adaptive mode (set_robot_mode(1)),
then the commanded phase. The JAX package's jitted scan is a Python loop over
ticks here: each tick's record stays on the device and the records are
stacked once at the end, so the only host reads in a tick are
`controller_step`'s own (its `mpc_due` branch and its MPC tick's).
"""

from __future__ import annotations

import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import FrameworkConfig
from quadruped_ctrl_tpu_torch.control import controller as ctrl
from quadruped_ctrl_tpu_torch.core.types import Command, tree_map
from quadruped_ctrl_tpu_torch.sim import engine
from quadruped_ctrl_tpu_torch.sim.terrain import Terrain

WARMUP_TICKS = 10
STAND_TICKS = 200


def make_command_sequence(cfg: FrameworkConfig, n_ticks: int, cmd: Command,
                          stand_ticks: int = STAND_TICKS):
    """(stand phase in mode 1 with zero velocity) + (commanded phase): a
    Command with a leading axis of n_ticks, where `cmd` lies."""
    dev = cmd.vel.device
    stand = Command.create(0.0, 0.0, 0.0, gait_type=9, robot_mode=1, device=dev)
    use_stand = torch.arange(n_ticks, device=dev) < stand_ticks
    return Command(
        vel=torch.where(use_stand[:, None], stand.vel, cmd.vel),
        gait_type=torch.where(use_stand, stand.gait_type, cmd.gait_type),
        robot_mode=torch.where(use_stand, stand.robot_mode, cmd.robot_mode),
    )


def rollout(
    cfg: FrameworkConfig,
    terrain: Terrain,
    commands: Command,            # leading axis = ticks
    mpc_iterations: int | None = None,
    record_every: int = 1,
    device=None,
):
    """Run a full closed-loop session on `device` (cuda:0 unless named; the
    terrain and commands lie there). Returns (final_ctrl, final_sim, traj).

    traj carries per-tick base position/rpy/velocity, torques and GRFs.
    `record_every` is accepted as in the JAX package, which does not read it
    either: every tick is recorded.
    """
    dev = _device.resolve(device)
    sim = engine.sim_init(cfg, terrain, device=dev)
    state = ctrl.init_state(cfg, device=dev)
    for _ in range(WARMUP_TICKS):
        state = ctrl.pre_work(cfg, state, engine.sensors_from_sim(cfg, sim))

    recs = []
    for i in range(commands.vel.shape[0]):
        sens = engine.sensors_from_sim(cfg, sim)
        state, out = ctrl.controller_step(cfg, state, sens,
                                          tree_map(lambda t: t[i], commands),
                                          mpc_iterations=mpc_iterations)
        sim = engine.sim_step(cfg, sim, out, terrain)
        recs.append(dict(
            p=sim.p,
            rpy=out.estimate.rpy,
            v=sim.v,
            est_p=out.estimate.position,
            est_v=out.estimate.v_world,
            tau=out.tau,
            fr=out.fr_des,
            contact=out.contact_state,
            safety=state.core.safety_ok,
        ))
    return state, sim, {k: torch.stack([rec[k] for rec in recs]) for k in recs[0]}


def run_session(cfg: FrameworkConfig, terrain: Terrain, cmd: Command,
                n_ticks: int, mpc_iterations: int | None = None, device=None):
    """The stand phase, then `cmd`, for n_ticks in all (the JAX package's
    jitted `run_session`; a plain function here), on `device` (cuda:0
    unless named)."""
    cmds = make_command_sequence(cfg, n_ticks, cmd)
    return rollout(cfg, terrain, cmds, mpc_iterations=mpc_iterations, device=device)
