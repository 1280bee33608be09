"""The full controller step: estimation -> gait -> placement -> MPC -> torques.

The counterpart of `quadruped_ctrl_tpu/control/controller.py`, the
re-derivation of the reference's per-tick pipeline (GaitCtrller::
TorqueCalculator, GaitCtrller.cpp:95-145, and ConvexMPCLocomotion::run,
ConvexMPCLocomotion.cpp:116-496) as a pure function over an explicit state
tree. Its semantics are the JAX package's, point for point:

* estimator order: contact -> orientation -> linear KF, with the KF consuming
  the *previous* tick's leg kinematics (GaitCtrller.cpp:58-63);
* the MPC fires when (iteration_counter + 1) % iterations_between_mpc == 0
  and the last solution is held between solves;
* safety failures latch and zero the torques forever (GaitCtrller.cpp:108-142):
  orientation and joint limits in `control_tick`, pDes and force feedforward
  in `leg_commands` on the actually commanded values;
* solver failures hold the previous MPC solution (SolverMPC.cpp:539-541): a
  non-finite or friction-infeasible solve keeps the last f_ff/Fr_des and bumps
  `mpc_fail_count`;
* the temporal warm start: each solve's pre-polish ADMM iterate, advanced by
  one gait segment, seeds the next.

Per-robot functions take unbatched tensors. The batched entry points
(`control_tick_batched`, `mpc_update_batched`) run them under
`torch.func.vmap` (`core.types.vmap`) around the batch-explicit parts: the
Kalman filter (`linear_kf.run_batched`), the formation
(`formation.qp_cost_packed`, kernel K1 on CUDA tensors) and the solve
(`admm.admm_mpc_batched`, whose factorizations run kernel K2). Where the JAX
code branches with `lax.cond` (`mpc_update`, `controller_step`; nothing
vmaps them), the port branches in Python on a 0-d bool tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import FrameworkConfig
from quadruped_ctrl_tpu_torch.control import desired_state, leg_controller, safety
from quadruped_ctrl_tpu_torch.control import swing as swing_mod
from quadruped_ctrl_tpu_torch.core.precision import exact_matmuls
from quadruped_ctrl_tpu_torch.core.types import (
    Command,
    ControllerOutput,
    ControllerState,
    EstimatorState,
    GaitParams,
    LegData,
    LocomotionState,
    Sensors,
    StateEstimate,
    Tree,
    tree_map,
    vmap,
)
from quadruped_ctrl_tpu_torch.estimation import linear_kf, orientation
from quadruped_ctrl_tpu_torch.gait import gait as gait_mod
from quadruped_ctrl_tpu_torch.mpc import formation
from quadruped_ctrl_tpu_torch.mpc.reference import build_reference
from quadruped_ctrl_tpu_torch.solver import admm
from quadruped_ctrl_tpu_torch.utils.timer import span


@dataclasses.dataclass(frozen=True)
class FullControllerState(Tree):
    """ControllerState plus the carried leg data / swing-trajectory values."""

    core: ControllerState
    prev_leg: LegData               # previous tick's kinematics (estimator lag)
    swing_p_cur: torch.Tensor       # (4,3) last computed swing position (world)
    swing_v_cur: torch.Tensor       # (4,3) last computed swing velocity (world)
    dsc: desired_state.DesiredStateCommandState

    @staticmethod
    def create(cfg: FrameworkConfig, device=None):
        dev = _device.resolve(device)

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        return FullControllerState(
            core=ControllerState.create(cfg.estimator.initial_p, cfg.mpc.h_max, device=dev),
            prev_leg=LegData(q=z(4, 3), qd=z(4, 3), p=z(4, 3), v=z(4, 3), jac=z(4, 3, 3)),
            swing_p_cur=z(4, 3),
            swing_v_cur=z(4, 3),
            dsc=desired_state.DesiredStateCommandState.create(device=dev),
        )


def _hips(cfg: FrameworkConfig, like: torch.Tensor) -> torch.Tensor:
    return _device.constant(cfg.robot.hip_locations(), like.device)


def _state_estimate(est: EstimatorState, ori: dict, position, v_world, v_body):
    return StateEstimate(
        position=position,
        v_world=v_world,
        v_body=v_body,
        orientation=ori["orientation"],
        r_body=ori["r_body"],
        rpy=ori["rpy"],
        omega_body=ori["omega_body"],
        omega_world=ori["omega_world"],
        a_body=ori["a_body"],
        a_world=ori["a_world"],
        contact_estimate=est.contact_phase,
    )


def run_estimators(cfg: FrameworkConfig, est: EstimatorState, sensors: Sensors,
                   prev_leg: LegData):
    """Contact + orientation + linear-KF estimators (GaitCtrller.cpp:20-27, 58-63)."""
    est, ori = orientation.run(est, sensors)
    xhat, p_cov, position, v_world, v_body = linear_kf.run(
        cfg.estimator, est.kf_xhat, est.kf_P, ori["a_world"], ori["r_body"],
        ori["omega_body"], _hips(cfg, est.kf_xhat), prev_leg.p, prev_leg.v,
        est.contact_phase,
    )
    est = est.replace(kf_xhat=xhat, kf_P=p_cov)
    return est, _state_estimate(est, ori, position, v_world, v_body)


def run_estimators_batched(cfg: FrameworkConfig, est: EstimatorState,
                           sensors: Sensors, prev_leg: LegData):
    """Batch-explicit `run_estimators`: the orientation part vmaps per
    scenario; the KF runs through `linear_kf.run_batched`."""
    est, ori = vmap(orientation.run)(est, sensors)
    xhat, p_cov, position, v_world, v_body = linear_kf.run_batched(
        cfg.estimator, est.kf_xhat, est.kf_P, ori["a_world"], ori["r_body"],
        ori["omega_body"], _hips(cfg, est.kf_xhat), prev_leg.p, prev_leg.v,
        est.contact_phase,
    )
    est = est.replace(kf_xhat=xhat, kf_P=p_cov)
    return est, _state_estimate(est, ori, position, v_world, v_body)


def apply_vel_deadband(cfg: FrameworkConfig, vel):
    """SetRobotVel's +-0.03 deadband (GaitCtrller.cpp:75-93)."""
    return torch.where(vel.abs() < cfg.control.vel_deadband, 0.0, vel)


def _setup_command(cfg: FrameworkConfig, loco: LocomotionState, gamepad, rpy):
    """Velocity low-pass + clamps + yaw targets (ConvexMPCLocomotion.cpp:76-114)."""
    c = cfg.control
    dt = cfg.dt
    x = loco.x_vel_des * (1 - c.x_filter) + gamepad[0] * c.x_filter
    y = loco.y_vel_des * (1 - c.y_filter) + gamepad[1] * c.y_filter
    w = loco.yaw_turn_rate * (1 - c.yaw_filter) + gamepad[2] * c.yaw_filter
    x = torch.clamp(x, c.vx_min, c.vx_max)
    y = torch.clamp(y, -c.vy_max, c.vy_max)
    yaw_des = rpy[2] + dt * w
    yaw_des_true = torch.where(
        (rpy[2] - loco.yaw_des_true).abs() > 5.0, rpy[2], loco.yaw_des_true
    )
    yaw_des_true = yaw_des_true + dt * w
    return loco.replace(
        x_vel_des=x,
        y_vel_des=y,
        yaw_turn_rate=w,
        yaw_des=yaw_des,
        yaw_des_true=yaw_des_true,
    )


def _select_gait(cfg: FrameworkConfig, loco: LocomotionState, cmd: Command):
    """Gait selection / aio reshape (ConvexMPCLocomotion.cpp:127-239).

    Returns (loco, params, gait_number, omni). The boundary check reads the
    phase the previous mode-1 tick stored (`aio_prev_phase`), which puts the
    MPC cadence on t % 13 == 0 as in the reference.
    """
    gait_number = cmd.gait_type
    omni = gait_number >= 20
    gait_number = torch.where(omni, gait_number - 20, gait_number)

    fixed = gait_mod.params_for_gait(gait_number)

    # aio (mode 1): reshape at gait-phase boundaries by commanded speed
    # (the reference's vBody = sqrt(vx^2) + vy^2, line 175)
    v_body = torch.sqrt(loco.x_vel_des ** 2) + loco.y_vel_des ** 2
    aio_new, aio_gait_number, counter_reset = gait_mod.aio_params(
        v_body, loco.yaw_turn_rate, loco.aio, loco.aio_prev_phase, cfg.mpc.h_max,
    )
    at_boundary = loco.aio_prev_phase == 0.0

    mode1 = cmd.robot_mode == 1
    params = GaitParams(
        offsets=torch.where(mode1, aio_new.offsets, fixed.offsets),
        durations=torch.where(mode1, aio_new.durations, fixed.durations),
        h=torch.where(mode1, aio_new.h, fixed.h),
    )
    gait_number = torch.where(mode1, aio_gait_number, gait_number)
    counter = torch.where(mode1 & counter_reset, torch.zeros_like(loco.iteration_counter),
                          loco.iteration_counter)
    # horizonLength: every mode-1 tick writes `h` (line 233), the local init
    # 10 unless this tick was a boundary that rebanded it; mode 0 never
    # writes it, so the MPC keeps solving the last mode-1 horizon
    mpc_h = torch.where(mode1, torch.where(at_boundary, aio_new.h, 10), loco.mpc_h)
    # this tick's aio phase (post-reset counter, new params) for the next
    # tick's boundary check; frozen while in mode 0
    _, cur_aio_phase = gait_mod.phase_of(counter, cfg.mpc.iterations_between_mpc, aio_new)
    aio_prev_phase = torch.where(mode1, cur_aio_phase, loco.aio_prev_phase)
    # the aio object itself is only touched while it is the active gait
    aio_kept = tree_map(lambda new, old: torch.where(mode1, new, old), aio_new, loco.aio)
    loco = loco.replace(aio=aio_kept, iteration_counter=counter, mpc_h=mpc_h,
                        aio_prev_phase=aio_prev_phase)
    return loco, params, gait_number, omni


@exact_matmuls
def control_tick(cfg: FrameworkConfig, state: FullControllerState,
                 sensors: Sensors, cmd: Command):
    """Everything except the MPC solve. Returns (state, tick_ctx).

    tick_ctx carries what `mpc_update` needs (gait table, estimate, feet).
    """
    est, se = run_estimators(cfg, state.core.estimator, sensors, state.prev_leg)
    return _tick_after_estimation(cfg, state, sensors, cmd, est, se)


@exact_matmuls
def control_tick_batched(cfg: FrameworkConfig, state, sensors, cmd):
    """Batch-explicit `control_tick`: the KF runs through
    `run_estimators_batched`, everything else vmaps per scenario.
    Semantically vmap(control_tick)."""
    est, se = run_estimators_batched(cfg, state.core.estimator, sensors, state.prev_leg)
    return vmap(
        lambda st, sn, c, e, s: _tick_after_estimation(cfg, st, sn, c, e, s)
    )(state, sensors, cmd, est, se)


def _tick_after_estimation(cfg: FrameworkConfig, state: FullControllerState,
                           sensors: Sensors, cmd: Command, est, se):
    core = state.core
    dt = cfg.dt
    leg = leg_controller.update_data(cfg.robot, sensors.q, sensors.qd)
    zero = torch.zeros_like(se.position[0])

    # --- safety: orientation check + joint-limit clamp (GaitCtrller.cpp:108-123)
    ok_ori = safety.check_orientation(cfg.safety, se.rpy)
    q_clamped, ok_joint = safety.check_joint_limits(cfg.safety, leg.q)
    leg = leg.replace(q=q_clamped)
    safety_ok = core.safety_ok & ok_ori & ok_joint

    # --- command pipeline ---
    gamepad = apply_vel_deadband(cfg, cmd.vel)
    # DesiredStateCommand runs every tick in the reference but ConvexMPC
    # consumes the raw gamepad command (GaitCtrller.cpp:105,125)
    dsc, _state_des = desired_state.convert_to_state_commands(
        state.dsc, torch.cat([gamepad, zero[None]]), cfg.dt
    )
    loco = _setup_command(cfg, core.locomotion, gamepad, se.rpy)
    prev_mpc_h = loco.mpc_h
    loco, params, gait_number, omni = _select_gait(cfg, loco, cmd)

    # warm-start hygiene: a gait or horizon switch invalidates the stored
    # temporal warm triple; `solution_ok` remains the backstop
    switched = (gait_number != loco.current_gait) | (loco.mpc_h != prev_mpc_h)

    def zero_on_switch(a):
        return torch.where(switched, torch.zeros_like(a), a)

    loco = loco.replace(
        mpc_warm_x=zero_on_switch(loco.mpc_warm_x),
        mpc_warm_z=zero_on_switch(loco.mpc_warm_z),
        mpc_warm_y=zero_on_switch(loco.mpc_warm_y),
    )

    # standing transition capture (ConvexMPCLocomotion.cpp:137-146)
    entering_stand = ((gait_number == 4) & (loco.current_gait != 4)) | loco.first_run
    stand_traj = torch.where(
        entering_stand,
        torch.stack([se.position[0], se.position[1], zero + cfg.control.stand_height,
                     zero, zero, se.rpy[2]]),
        loco.stand_traj,
    )
    wpd = loco.world_position_desired
    wpd = torch.where(entering_stand, torch.stack([stand_traj[0], stand_traj[1], wpd[2]]), wpd)
    loco = loco.replace(current_gait=gait_number, stand_traj=stand_traj,
                        world_position_desired=wpd)

    segment, phase = gait_mod.phase_of(loco.iteration_counter,
                                       cfg.mpc.iterations_between_mpc, params)

    # velocities / terrain compensation (lines 242-265)
    v_des_robot = torch.stack([loco.x_vel_des, loco.y_vel_des, zero])
    r_body_t = se.r_body.T
    v_des_world = torch.where(omni, v_des_robot, r_body_t @ v_des_robot)
    v_robot = se.v_world

    rpy_int = loco.rpy_int
    int1 = rpy_int[1] + torch.where(v_robot[0].abs() > 0.2,
                                    dt * (0.0 - se.rpy[1]) / v_robot[0], 0.0)
    int0 = rpy_int[0] + torch.where(v_robot[1].abs() > 0.1,
                                    dt * (0.0 - se.rpy[0]) / v_robot[1], 0.0)
    rpy_int = torch.clamp(torch.stack([int0, int1, rpy_int[2]]),
                          -cfg.control.rpy_int_max, cfg.control.rpy_int_max)
    rpy_comp = torch.stack([v_robot[1] * rpy_int[0], v_robot[0] * rpy_int[1], zero])
    loco = loco.replace(rpy_int=rpy_int, rpy_comp=rpy_comp)

    # world-frame foot positions (lines 269-274)
    hips = _hips(cfg, se.position)
    p_foot = se.position[None, :] + torch.einsum("ij,fj->fi", r_body_t, hips + leg.p)

    # desired world position integration (non-standing; lines 276-280)
    standing = gait_number == 4
    wpd = loco.world_position_desired
    wpd = torch.where(standing, wpd,
                      wpd + dt * torch.stack([v_des_world[0], v_des_world[1], zero]))

    # firstRun init (lines 283-295); wpd[2] holds yaw in the reference — kept
    first = loco.first_run
    wpd = torch.where(first, torch.stack([se.position[0], se.position[1], se.rpy[2]]), wpd)
    swing_p0 = torch.where(first, p_foot, loco.swing_p0)
    swing_pf = torch.where(first, p_foot, loco.swing_pf)
    loco = loco.replace(world_position_desired=wpd, swing_p0=swing_p0,
                        swing_pf=swing_pf, first_run=torch.zeros_like(first))

    # swing timing (lines 297-314)
    dt_mpc = cfg.dt_mpc
    swing_times = gait_mod.swing_time(dt_mpc, params)
    stance_times = gait_mod.stance_time(dt_mpc, params)
    swing_time_remaining = torch.where(loco.first_swing, swing_times,
                                       loco.swing_time_remaining - dt)

    # foot placement (lines 304-371)
    pf_target = swing_mod.foot_placement(
        cfg, hips, se.position, r_body_t, se.v_world, v_des_robot, v_des_world,
        loco.yaw_turn_rate, stance_times, swing_time_remaining,
    )
    loco = loco.replace(swing_pf=pf_target, swing_time_remaining=swing_time_remaining)

    # counter increment (line 375)
    loco = loco.replace(iteration_counter=loco.iteration_counter + 1)

    contact_states = gait_mod.contact_state(phase, params)
    swing_states = gait_mod.swing_state(phase, params)
    mpc_table = gait_mod.mpc_table(segment, params, cfg.mpc.h_max)
    mpc_due = (loco.iteration_counter % cfg.mpc.iterations_between_mpc) == 0

    core = core.replace(estimator=est, locomotion=loco, safety_ok=safety_ok,
                        gamepad=gamepad)
    state = state.replace(core=core, prev_leg=leg, dsc=dsc)

    ctx = dict(
        se=se,
        leg=leg,
        p_foot=p_foot,
        v_des_world=v_des_world,
        mpc_table=mpc_table,
        mpc_due=mpc_due,
        standing=standing,
        contact_states=contact_states,
        swing_states=swing_states,
        swing_times=swing_times,
        params=params,
    )
    return state, ctx


def _mpc_problem_inputs(cfg: FrameworkConfig, state: FullControllerState, ctx,
                        h_sol: int):
    """Pre-dynamics formation inputs: reference trajectory, x-drag, x0, step
    mask and contact table over the first `h_sol` table rows — everything of
    solveDenseMPC's pre-cost half (ConvexMPCLocomotion.cpp:592-665) except
    the SRB linearization itself."""
    loco = state.core.locomotion
    se: StateEstimate = ctx["se"]

    traj, wpd = build_reference(
        cfg, ctx["standing"], loco.stand_traj, loco.world_position_desired,
        se.position, loco.rpy_comp, loco.yaw_des_true, loco.yaw_turn_rate,
        ctx["v_des_world"], h_sol,
    )

    # x-drag integral: solve uses the PRE-update value (solveDenseMPC:632-640)
    x_drag = loco.x_comp_integral
    pz_err = se.position[2] - cfg.control.body_height
    vx = se.v_world[0]
    x_comp = torch.where(
        vx.abs() > 0.3,
        loco.x_comp_integral + cfg.mpc.x_comp_drag * pz_err * cfg.dt_mpc / vx,
        loco.x_comp_integral,
    )

    r_feet = ctx["p_foot"] - se.position[None, :]
    x0 = formation.build_x0(se.rpy, se.position, se.omega_world, se.v_world,
                            cfg.mpc.gravity)
    # the solved horizon is loco.mpc_h (sticky horizonLength), not the gait's
    # own segment count: the QP covers the table's first mpc_h rows
    step_mask = (torch.arange(h_sol, device=x0.device) < loco.mpc_h).to(torch.float32)
    table = ctx["mpc_table"][:h_sol] * step_mask[:, None]
    return (r_feet, se.rpy[2], x_drag, x0, traj, step_mask, table, wpd, x_comp)


def _mpc_problem_parts(cfg: FrameworkConfig, state: FullControllerState, ctx,
                       h_sol: int):
    """`_mpc_problem_inputs` + the SRB discretized dynamics (closed form)."""
    (r_feet, yaw, x_drag, x0, traj, step_mask, table, wpd, x_comp) = \
        _mpc_problem_inputs(cfg, state, ctx, h_sol)
    adt, bdt = formation.srb_discrete(cfg.mpc, r_feet, yaw, x_drag, cfg.dt_mpc)
    return adt, bdt, x0, traj, step_mask, table, wpd, x_comp


def _mpc_problem(cfg: FrameworkConfig, state: FullControllerState, ctx, h_sol: int):
    """Per-scenario condensed-QP build (the formation half of solveDenseMPC,
    ConvexMPCLocomotion.cpp:592-665). Returns (hess, grad, table, wpd,
    x_comp)."""
    adt, bdt, x0, traj, step_mask, table, wpd, x_comp = _mpc_problem_parts(
        cfg, state, ctx, h_sol)
    hess, grad = formation.qp_cost_nil(cfg.mpc, adt, bdt, x0, traj, step_mask)
    return hess, grad, table, wpd, x_comp


def _mpc_problem_compressed(cfg: FrameworkConfig, state: FullControllerState,
                            ctx, h_sol: int, max_stance: int):
    """Stance-compressed QP build: the reference's swing-variable elimination
    (SolverMPC.cpp:441-525) as a static-shape gather, producing
    (3*max_stance*h_sol)-variable systems. Correct whenever every step of the
    gait table has <= max_stance stance feet. Returns
    (hess, grad, foot_idx, gait_red, table, wpd, x_comp)."""
    adt, bdt, x0, traj, step_mask, table, wpd, x_comp = _mpc_problem_parts(
        cfg, state, ctx, h_sol)
    foot_idx, gait_red = formation.compress_stance(table, max_stance)
    hess, grad = formation.qp_cost_compressed_nil(cfg.mpc, adt, bdt, x0, traj,
                                                  step_mask, foot_idx)
    return hess, grad, foot_idx, gait_red, table, wpd, x_comp


@exact_matmuls
def mpc_update(cfg: FrameworkConfig, state: FullControllerState, ctx,
               iterations: int | None = None):
    """Reference trajectory + formation + ADMM solve; updates f_ff/Fr_des
    (updateMPCIfNeeded + solveDenseMPC, ConvexMPCLocomotion.cpp:498-687).
    Only applied when ctx['mpc_due'].

    With `iterations=None` the budget is picked at run time: the reduced
    `cfg.solver.warm_iterations` whenever the stored warm triple is live, the
    full cold `cfg.solver.iterations` at start-up and after a solver
    failure (where `_store_warm` resets the triple to zeros). The choice is a
    Python branch on the triple (one host sync on this per-robot path)."""
    h_max = cfg.mpc.h_max
    hess, grad, table, wpd, x_comp = _mpc_problem(cfg, state, ctx, h_max)
    loco0 = state.core.locomotion
    warm_in = _warm_slices(loco0, h_max)
    if iterations is None:
        live = any(bool((w != 0).any()) for w in warm_in)
        iterations = cfg.solver.warm_iterations if live else cfg.solver.iterations
    forces, warm = admm.admm_mpc(cfg.solver, cfg.mpc, hess, grad, table,
                                 iterations=iterations, warm=warm_in, return_warm=True)
    forces = forces.reshape(h_max, 4, 3)
    ok = solution_ok(cfg, forces, table)
    loco = _accept_solution(cfg, loco0, ctx["se"], forces, table, ok=ok)
    loco = _store_warm(loco, warm, h_max, h_max, ok)
    loco = loco.replace(world_position_desired=wpd, x_comp_integral=x_comp)
    return state.replace(core=state.core.replace(locomotion=loco))


def _accepted(cfg: FrameworkConfig, h_sol: int):
    """The per-scenario acceptance of a solve (vmapped by the batched paths)."""
    h_max = cfg.mpc.h_max

    def accept(s, se, f, t, w, wpd_i, xc):
        ok = solution_ok(cfg, f, t)
        loco = _accept_solution(cfg, s.core.locomotion, se, f, t, ok=ok)
        loco = _store_warm(loco, w, h_sol, h_max, ok)
        loco = loco.replace(world_position_desired=wpd_i, x_comp_integral=xc)
        return s.replace(core=s.core.replace(locomotion=loco))

    return accept


@exact_matmuls
def mpc_update_batched(cfg: FrameworkConfig, state: FullControllerState, ctx,
                       h_sol: int | None = None,
                       iterations: int | None = None,
                       polish_rounds: int | None = None,
                       max_stance: int | None = None,
                       pack: int = 2,
                       use_kernels: bool | None = None):
    """Batch-axis-explicit `mpc_update`, the closed-loop solve.

    Semantically vmap(mpc_update) (identical formation and splitting), with
    the solves through `admm.admm_mpc_batched`. `h_sol` is the static solved
    horizon; it should be >= every scenario's `loco.mpc_h` (cfg.mpc.h_max is
    always safe; 10 for mode-0 sweeps after a mode-1 stand-up). A scenario
    whose mpc_h exceeds h_sol degrades to an h_sol-step MPC.

    `max_stance` enables stance compression + block-diagonal packing
    (`pipeline.solve_packed_batch`'s shape); correct only when every
    scenario's gait table has <= max_stance stance feet per step. None solves
    the full 12*h_sol-variable systems. `pack` scenarios (a divisor of the
    batch) share one KKT system in the compressed path.

    `use_kernels` (the port's own) is passed to `formation.qp_cost_packed`
    and `admm.admm_mpc_batched`: None runs kernels K1 and K2 on CUDA
    tensors; False runs their plain versions."""
    h_sol = cfg.mpc.h_max if h_sol is None else h_sol
    if max_stance is not None and max_stance < 4:
        return _mpc_update_batched_packed(cfg, state, ctx, h_sol, iterations,
                                          polish_rounds, max_stance, pack, use_kernels)
    (r_feet, yaw, x_drag, x0, traj, step_mask, table, wpd, x_comp) = vmap(
        lambda s, c: _mpc_problem_inputs(cfg, s, c, h_sol))(state, ctx)
    adt, bdt = formation.srb_discrete(cfg.mpc, r_feet, yaw, x_drag, cfg.dt_mpc)
    bsz = r_feet.shape[0]
    sel4 = torch.eye(4, dtype=torch.float32, device=adt.device).expand(bsz, h_sol, 4, 4)
    # pack=1: per-scenario (12*h_sol)-variable systems
    hess, grad = formation.qp_cost_packed(cfg.mpc, adt, bdt, x0, traj, step_mask, sel4,
                                          pack=1, use_kernels=use_kernels)
    loco = state.core.locomotion
    warm = tuple(w[:, :h_sol].reshape(bsz, -1)
                 for w in (loco.mpc_warm_x, loco.mpc_warm_z, loco.mpc_warm_y))
    x, warm_out = admm.admm_mpc_batched(
        cfg.solver, cfg.mpc, hess, grad, table, iterations=iterations,
        polish_rounds=polish_rounds, use_kernels=use_kernels, warm=warm,
        return_warm=True,
    )
    forces = x.reshape(-1, h_sol, 4, 3)
    return vmap(_accepted(cfg, h_sol))(state, ctx["se"], forces, table, warm_out, wpd,
                                       x_comp)


def _mpc_update_batched_packed(cfg: FrameworkConfig, state, ctx, h_sol: int,
                               iterations, polish_rounds, max_stance: int,
                               pack: int, use_kernels: bool | None = None):
    """The stance-compressed + pair-packed closed-loop solve: identical
    formation inputs and ADMM splitting to the full path, with the solves on
    (pack * 3*max_stance*h_sol)-variable block-diagonal KKT systems. Warm
    triples are stored in the full (h_max, 4, d) layout and gathered /
    scattered through each tick's stance index map, so the temporal warm
    start survives the table rolling one segment between solves."""
    ms = max_stance
    (r_feet, yaw, x_drag, x0, traj, step_mask, table, wpd, x_comp) = vmap(
        lambda s, c: _mpc_problem_inputs(cfg, s, c, h_sol))(state, ctx)
    adt, bdt = formation.srb_discrete(cfg.mpc, r_feet, yaw, x_drag, cfg.dt_mpc)
    foot_idx, gait_red, sel = formation.stance_selectors(table, ms)
    b = r_feet.shape[0]
    if b % pack != 0:
        pack = 1        # odd batches still compress; they just don't pack
    n_c = 3 * ms * h_sol
    m_c = 5 * ms * h_sol
    kp, gp = formation.qp_cost_packed(cfg.mpc, adt, bdt, x0, traj, step_mask, sel, pack,
                                      use_kernels=use_kernels)

    # gather the stored full-layout warm triples through this tick's stance
    # map (swing-foot entries drop out; their forces/duals are ~0 anyway)
    fi = foot_idx.long()                                      # (B, h_sol, ms)
    loco = state.core.locomotion

    def gather_warm(wfull):
        d = wfull.shape[-1]
        red = torch.gather(wfull[:, :h_sol], 2, fi[..., None].expand(b, h_sol, ms, d))
        return red.reshape(b // pack, -1)

    warm_p = (gather_warm(loco.mpc_warm_x), gather_warm(loco.mpc_warm_z),
              gather_warm(loco.mpc_warm_y))
    gaitp = gait_red.reshape(b // pack, pack * h_sol, ms)
    xp, warm_out = admm.admm_mpc_batched(
        cfg.solver, cfg.mpc, kp, gp, gaitp, iterations=iterations,
        polish_rounds=polish_rounds, use_kernels=use_kernels, warm=warm_p,
        return_warm=True, pack=pack,
    )
    forces = formation.scatter_forces(xp.reshape(b, n_c), foot_idx, h_sol)

    # scatter the solver's warm triple back to the full layout
    def scatter_warm(red, d):
        r = red.reshape(b, h_sol, ms, d)
        full = torch.zeros((b, h_sol, 4, d), dtype=torch.float32, device=r.device)
        return full.scatter(2, fi[..., None].expand(b, h_sol, ms, d), r).reshape(b, -1)

    wxo, wzo, wyo = warm_out
    warm_full = (scatter_warm(wxo.reshape(b, n_c), 3), scatter_warm(wzo.reshape(b, m_c), 5),
                 scatter_warm(wyo.reshape(b, m_c), 5))
    return vmap(_accepted(cfg, h_sol))(state, ctx["se"], forces, table, warm_full, wpd,
                                       x_comp)


def solution_ok(cfg: FrameworkConfig, forces, table):
    """Solver-failure detector: finite solution + friction-pyramid primal
    feasibility within cfg.solver.fail_primal_tol (in Newtons)."""
    ax = formation.pyramid_apply(cfg.mpc, forces)              # (h,4,5)
    l3, u3 = formation.pyramid_bounds(cfg.mpc, table.to(forces.dtype))
    up_viol = torch.where(u3 < cfg.solver.infty, ax - u3, 0.0)
    viol = torch.amax(torch.maximum(l3 - ax, up_viol))
    return torch.isfinite(forces).all() & (viol < cfg.solver.fail_primal_tol)


def _accept_solution(cfg: FrameworkConfig, loco, se: StateEstimate, forces,
                     table, ok=None):
    """Accept the MPC forces, or hold the previous solution on solver failure
    (SolverMPC.cpp:539-541 / convexMPC_interface.cpp:175-180; counted in
    loco.mpc_fail_count)."""
    ok = solution_ok(cfg, forces, table) if ok is None else ok
    fr_des = torch.where(ok, forces[0], loco.fr_des)       # first-step forces
    f_ff = -torch.einsum("ij,fj->fi", se.r_body, fr_des)  # body frame, reaction
    return loco.replace(
        f_ff=f_ff, fr_des=fr_des,
        mpc_fail_count=loco.mpc_fail_count + (1 - ok.to(torch.int32)),
    )


def _warm_slices(loco, h_sol: int):
    """The stored warm-start triple, flattened to the solver's layout for an
    h_sol-step problem (zeros = cold start)."""
    return (
        loco.mpc_warm_x[:h_sol].reshape(-1),
        loco.mpc_warm_z[:h_sol].reshape(-1),
        loco.mpc_warm_y[:h_sol].reshape(-1),
    )


def _store_warm(loco, warm, h_sol: int, h_max: int, ok):
    """Advance the solver's returned warm triple by one gait segment and store
    it at h_max size. Failed or non-finite solves reset the store to zeros
    (cold restart)."""

    def shift(w, d):
        w = w.reshape(h_sol, 4, d)
        w = torch.cat([w[1:], w[-1:]], dim=0)
        return torch.cat([w, torch.zeros((h_max - h_sol, 4, d), dtype=torch.float32,
                                         device=w.device)], dim=0)

    wx, wz, wy = warm
    good = ok
    for w in warm:
        good = good & torch.isfinite(w).all()
    sx, sz, sy = shift(wx, 3), shift(wz, 5), shift(wy, 5)

    def keep(a):
        return torch.where(good, a, torch.zeros_like(a))

    return loco.replace(mpc_warm_x=keep(sx), mpc_warm_z=keep(sz), mpc_warm_y=keep(sy))


@exact_matmuls
def leg_commands(cfg: FrameworkConfig, state: FullControllerState, ctx):
    """Swing/stance command writing + torque mapping + safety gate
    (ConvexMPCLocomotion.cpp:394-472, LegController.cpp:113-188,
    GaitCtrller.cpp:128-142). Returns (state, ControllerOutput)."""
    core = state.core
    loco = core.locomotion
    se: StateEstimate = ctx["se"]
    leg: LegData = ctx["leg"]
    swing_states = ctx["swing_states"]
    contact_states = ctx["contact_states"]
    in_swing = swing_states > 0

    # swing start: reset p0 to the current foot position
    start_swing = in_swing & loco.first_swing
    swing_p0 = torch.where(start_swing[:, None], ctx["p_foot"], loco.swing_p0)
    first_swing = ~in_swing

    p_sw, v_sw, _ = swing_mod.swing_trajectory(
        swing_p0, loco.swing_pf, cfg.swing.height, swing_states, ctx["swing_times"])
    # stance feet keep the last computed trajectory point (zero velocity at
    # touchdown) — ConvexMPCLocomotion.cpp:439-444 semantics
    p_traj = torch.where(in_swing[:, None], p_sw, state.swing_p_cur)
    v_traj = torch.where(in_swing[:, None], v_sw, state.swing_v_cur)

    hips = _hips(cfg, se.position)
    p_des_leg = torch.einsum("ij,fj->fi", se.r_body, p_traj - se.position[None, :]) - hips
    v_des_leg = torch.einsum("ij,fj->fi", se.r_body, v_traj - se.v_world[None, :])

    dev = se.position.device
    kp_sw = _device.constant(cfg.control.kp_cartesian, dev)
    kd_sw = _device.constant(cfg.control.kd_cartesian, dev)
    kp = torch.where(in_swing[:, None], kp_sw[None, :], 0.0)
    kd = torch.where(in_swing[:, None], kd_sw[None, :],
                     cfg.control.kd_stance_scale * kd_sw[None, :])
    force_ff = torch.where(in_swing[:, None], 0.0, loco.f_ff)

    # safety cascade, second half (GaitCtrller.cpp:113-118): pDes and
    # force-feedforward checks on the actually-commanded values
    p_des_leg, ok_pdes = safety.check_p_des_foot(cfg.safety, cfg.robot, p_des_leg)
    force_ff, ok_force = safety.check_force_feedforward(cfg.safety, force_ff)
    safety_ok = core.safety_ok & ok_pdes & ok_force

    tau = leg_controller.update_command(cfg.control, leg, p_des_leg, v_des_leg, kp, kd,
                                        force_ff)
    tau = torch.where(safety_ok, tau, torch.zeros_like(tau))

    # contact phase feedback to the estimator (line 472)
    se_contact = torch.where(in_swing, 0.0, contact_states)
    est = core.estimator.replace(contact_phase=se_contact)

    loco = loco.replace(first_swing=first_swing, swing_p0=swing_p0)
    core = core.replace(estimator=est, locomotion=loco, safety_ok=safety_ok)
    state = state.replace(core=core, swing_p_cur=p_traj, swing_v_cur=v_traj)

    wpd = loco.world_position_desired
    v_des_world = ctx["v_des_world"]
    out = ControllerOutput(
        tau=tau,
        p_foot_des=p_traj,
        v_foot_des=v_traj,
        fr_des=loco.fr_des,
        contact_state=contact_states,
        swing_state=swing_states,
        p_body_des=torch.stack([wpd[0], wpd[1], torch.zeros_like(wpd[0])
                                + cfg.control.body_height]),
        v_body_des=torch.cat([v_des_world[:2], torch.zeros_like(v_des_world[2:])]),
        estimate=se,
    )
    return state, out


@exact_matmuls
def controller_step(cfg: FrameworkConfig, state: FullControllerState,
                    sensors: Sensors, cmd: Command,
                    mpc_iterations: int | None = None):
    """Single-robot full tick with the MPC every iterations_between_mpc ticks
    (a Python branch on ctx['mpc_due'], holding the last solution
    otherwise). A `qct.controller_step` span holds the tick, with its stages
    `qct.control_tick`, `qct.mpc_update` (only when the MPC fires) and
    `qct.leg_commands` inside."""
    with span("qct.controller_step"):
        with span("qct.control_tick"):
            state, ctx = control_tick(cfg, state, sensors, cmd)
        if bool(ctx["mpc_due"]):
            with span("qct.mpc_update"):
                state = mpc_update(cfg, state, ctx, iterations=mpc_iterations)
        with span("qct.leg_commands"):
            return leg_commands(cfg, state, ctx)


@exact_matmuls
def pre_work(cfg: FrameworkConfig, state: FullControllerState, sensors: Sensors):
    """Estimator warm-up tick: run estimators + leg-data update, no control
    (the reference's pre_work FFI call, GaitCtrller.cpp:58-63, used 10x at
    reset, walking_simulation.py:185-189)."""
    est, _ = run_estimators(cfg, state.core.estimator, sensors, state.prev_leg)
    leg = leg_controller.update_data(cfg.robot, sensors.q, sensors.qd)
    return state.replace(core=state.core.replace(estimator=est), prev_leg=leg)


def init_state(cfg: FrameworkConfig, device=None) -> FullControllerState:
    """The controller's initial state, on `device` (cuda:0 unless named)."""
    return FullControllerState.create(cfg, device=device)
