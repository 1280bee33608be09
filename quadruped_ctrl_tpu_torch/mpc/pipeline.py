"""The MPC pipeline: formation -> QP -> ADMM -> forces.

The counterpart of `quadruped_ctrl_tpu/mpc/pipeline.py`: the per-scenario
solves `solve` and `solve_compressed` with their `torch.func.vmap` batches
`solve_batch` and `solve_compressed_batch`, the batched packed solve
`solve_packed_batch`, the inputs and the random scenario generator. The
work runs where the inputs lie. Each solve is a `qct.solve` span, its
formation a `qct.formation` span inside it (`utils/timer.span`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import FrameworkConfig
from quadruped_ctrl_tpu_torch.core.types import Tree, vmap
from quadruped_ctrl_tpu_torch.mpc import formation
from quadruped_ctrl_tpu_torch.solver import admm
from quadruped_ctrl_tpu_torch.utils.timer import span


@dataclasses.dataclass(frozen=True)
class MPCInputs(Tree):
    """Per-scenario solver inputs with a leading batch axis (the reference's
    update_data_t, convexMPC_interface.h:10-38). All float32."""

    rpy: torch.Tensor          # (B,3)
    position: torch.Tensor     # (B,3)
    omega_world: torch.Tensor  # (B,3)
    v_world: torch.Tensor      # (B,3)
    r_feet: torch.Tensor       # (B,4,3) foot positions relative to CoM, world
    traj: torch.Tensor         # (B,h,13) reference (13th column zero)
    gait_table: torch.Tensor   # (B,h,4)
    x_drag: torch.Tensor       # (B,)

    @classmethod
    def from_numpy(cls, arrays: dict, device=None) -> "MPCInputs":
        """From a dict of arrays keyed by field name (for example
        `np.asarray` of each field of the JAX package's MPCInputs), on
        `device`: cuda:0 unless the caller names another device. Every
        field becomes float32 (a 0/1 integer gait table too)."""
        dev = _device.resolve(device)
        return cls(**{f.name: torch.as_tensor(np.array(arrays[f.name], np.float32),
                                              device=dev)
                      for f in dataclasses.fields(cls)})


def random_inputs(seed: int, batch: int, h: int, trot: bool = True,
                  device=None) -> MPCInputs:
    """Random-but-realistic scenario batch with the JAX package's
    distributions (the JCQP ProblemGenerator pattern), drawn from a numpy
    Generator seeded with `seed`, on `device` (cuda:0 unless named). The
    gait table is a trot (`trot=True`) or all four feet in stance."""
    rng = np.random.default_rng(seed)

    def uniform(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    rpy = uniform(-0.1, 0.1, (batch, 3))
    position = np.concatenate([uniform(-1.0, 1.0, (batch, 2)),
                               uniform(0.25, 0.3, (batch, 1))], axis=1)
    omega = uniform(-0.3, 0.3, (batch, 3))
    v = uniform(-0.5, 0.5, (batch, 3))
    r_feet = uniform(-0.25, 0.25, (batch, 4, 3))
    r_feet[:, :, 2] = uniform(-0.30, -0.25, (batch, 4))
    traj = np.zeros((batch, h, 13), np.float32)
    traj[:, :, 5] = 0.25
    traj[:, :, 9] = v[:, None, 0]
    if trot:
        half = h // 2
        tbl = np.zeros((h, 4), np.float32)
        tbl[:half, 0] = tbl[:half, 3] = 1.0
        tbl[half:, 1] = tbl[half:, 2] = 1.0
    else:
        tbl = np.ones((h, 4), np.float32)
    gait = np.broadcast_to(tbl, (batch, h, 4))
    return MPCInputs.from_numpy(dict(
        rpy=rpy, position=position, omega_world=omega, v_world=v,
        r_feet=r_feet, traj=traj, gait_table=gait,
        x_drag=np.zeros((batch,), np.float32)), device=device)


def _dynamics(cfg: FrameworkConfig, inp: MPCInputs):
    """One scenario's (Adt, Bdt, x0)."""
    a_ct, b_ct = formation.srb_ct_dynamics(cfg.mpc, inp.r_feet, inp.rpy[2], inp.x_drag)
    adt, bdt = formation.discretize(a_ct, b_ct, cfg.dt_mpc)
    x0 = formation.build_x0(inp.rpy, inp.position, inp.omega_world, inp.v_world,
                            cfg.mpc.gravity)
    return adt, bdt, x0


def solve(cfg: FrameworkConfig, inp: MPCInputs, h: int | None = None,
          iterations: int | None = None, polish_rounds: int | None = None):
    """One full MPC solve of one scenario (`inp` fields without a batch
    axis): SRB dynamics, discretization, condensed QP, `admm.admm_mpc`.
    Returns forces (h, 4, 3), world frame."""
    h = inp.gait_table.shape[0] if h is None else h
    with span("qct.solve"):
        with span("qct.formation"):
            adt, bdt, x0 = _dynamics(cfg, inp)
            step_mask = torch.ones((h,), dtype=torch.float32, device=adt.device)
            hess, grad = formation.qp_cost_nil(cfg.mpc, adt, bdt, x0, inp.traj, step_mask)
        forces = admm.admm_mpc(cfg.solver, cfg.mpc, hess, grad, inp.gait_table,
                               iterations=iterations, polish_rounds=polish_rounds)
        return forces.reshape(h, 4, 3)


def solve_batch(cfg: FrameworkConfig, inputs: MPCInputs, **kw):
    """`solve` vmapped over the leading batch axis: forces (B, h, 4, 3)."""
    return vmap(lambda i: solve(cfg, i, **kw))(inputs)


def solve_compressed(cfg: FrameworkConfig, inp: MPCInputs, max_stance: int,
                     h: int | None = None, iterations: int | None = None,
                     polish_rounds: int | None = None):
    """One scenario's MPC solve over its stance-foot variables only (the
    reference's swing-variable elimination, SolverMPC.cpp:441-525, as a
    static-shape gather of `max_stance` slots per step). Returns forces
    (h, 4, 3) with zeros on the dropped swing feet."""
    h = inp.gait_table.shape[0] if h is None else h
    with span("qct.solve"):
        with span("qct.formation"):
            adt, bdt, x0 = _dynamics(cfg, inp)
            foot_idx, gait_red = formation.compress_stance(inp.gait_table, max_stance)
            step_mask = torch.ones((h,), dtype=torch.float32, device=adt.device)
            hess, grad = formation.qp_cost_compressed_nil(cfg.mpc, adt, bdt, x0, inp.traj,
                                                          step_mask, foot_idx)
        x_red = admm.admm_mpc(cfg.solver, cfg.mpc, hess, grad, gait_red,
                              iterations=iterations, polish_rounds=polish_rounds)
        return formation.scatter_forces(x_red, foot_idx, h)


def solve_compressed_batch(cfg: FrameworkConfig, inputs: MPCInputs, max_stance: int, **kw):
    """`solve_compressed` vmapped over the leading batch axis."""
    return vmap(lambda i: solve_compressed(cfg, i, max_stance, **kw))(inputs)


def solve_packed_batch(cfg: FrameworkConfig, inputs: MPCInputs,
                       max_stance: int = 2, pack: int = 2,
                       h: int | None = None,
                       iterations: int | None = None,
                       polish_rounds: int | None = None,
                       use_fused: bool | None = None,
                       form_only: bool = False,
                       use_kernels: bool | None = None):
    """Stance-compressed, pair-packed batched solve: `pack` compressed
    scenarios share one block-diagonal KKT system (a trot at h=10: 2 x 60
    variables in one 120-variable system). Returns forces (B, h, 4, 3) with
    zeros on swing feet. `h` defaults to the gait table's horizon.

    `use_fused` solves each scenario alone (no packing; `pack` and
    `form_only` are then ignored, as in the JAX function) through the
    single-launch solve K5 (`solver/admm.admm_mpc_fused`). `use_kernels`
    defaults to whether the inputs lie on a CUDA device."""
    b = inputs.rpy.shape[0]
    if b % pack:
        raise ValueError(f"batch {b} is not a multiple of pack={pack}")
    h = inputs.gait_table.shape[1] if h is None else h
    n_c = 3 * max_stance * h

    with span("qct.solve"):
        with span("qct.formation"):
            adt, bdt = formation.srb_discrete(
                cfg.mpc, inputs.r_feet, inputs.rpy[:, 2], inputs.x_drag, cfg.dt_mpc)
            x0 = formation.build_x0(inputs.rpy, inputs.position, inputs.omega_world,
                                    inputs.v_world, cfg.mpc.gravity)
            foot_idx, gait_red, sel = formation.stance_selectors(inputs.gait_table,
                                                                 max_stance)
            step_mask = torch.ones((b, h), dtype=torch.float32, device=adt.device)
            if use_fused:
                # the single-launch polish takes its best-iterate and
                # violation reductions over the whole system, so each
                # scenario gets its own (padded) tile instead of a packed one
                hess, grad = formation.qp_cost_compressed_nil_sel(
                    cfg.mpc, adt, bdt, x0, inputs.traj, step_mask, sel)
            else:
                kp, gp = formation.qp_cost_packed(cfg.mpc, adt, bdt, x0, inputs.traj,
                                                  step_mask, sel, pack,
                                                  use_kernels=use_kernels)
        if use_fused:
            xp = admm.admm_mpc_fused(cfg.solver, cfg.mpc, hess, grad, gait_red,
                                     iterations=iterations,
                                     polish_rounds=polish_rounds,
                                     use_kernels=use_kernels)
            return formation.scatter_forces(xp.reshape(b, n_c), foot_idx, h)
        if form_only:
            # formation-phase timing without the solve: the returned "forces"
            # depend on every formed quantity, but nothing is factorized
            probe = (kp.sum(dim=(1, 2)) + gp.sum(dim=1)) * 1e-12
            probe = probe[:, None].expand(b // pack, pack)
            return probe.reshape(b, 1, 1, 1).expand(b, h, 4, 3)
        gaitp = gait_red.reshape(b // pack, pack * h, max_stance)
        xp = admm.admm_mpc_batched(cfg.solver, cfg.mpc, kp, gp, gaitp,
                                   iterations=iterations,
                                   polish_rounds=polish_rounds,
                                   use_kernels=use_kernels, pack=pack)
        return formation.scatter_forces(xp.reshape(b, n_c), foot_idx, h)
