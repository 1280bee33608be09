"""Batched scenario engine with macro-stepped MPC cadence.

The counterpart of `quadruped_ctrl_tpu/sim/batch_rollout.py`. Every
scenario's MPC fires at the same global ticks, (t+1) % 13 == 0 (aio resets
happen only at phase boundaries, which are multiples of
iterations_between_mpc), so the rollout is a loop over macro-steps: one MPC
tick followed by 12 plain ticks, with no per-lane divergence — the
structural replacement for the reference's
`if(iterationCounter % iterationsBetweenMPC) == 0`
(ConvexMPCLocomotion.cpp:502). The JAX package's `lax.scan`s are Python
loops here; the per-lane controller and physics run under
`torch.func.vmap`, the Kalman filter and the MPC solve batch-explicit.

On CUDA tensors the MPC ticks run kernel K1 (the formation,
`formation.qp_cost_packed`) and K2 (the factorizations of
`admm.admm_mpc_batched`) unless `use_kernels=False`.
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import FrameworkConfig
from quadruped_ctrl_tpu_torch.control import controller as ctrl
from quadruped_ctrl_tpu_torch.core.types import Command, tree_map, vmap
from quadruped_ctrl_tpu_torch.sim import engine
from quadruped_ctrl_tpu_torch.sim.terrain import Terrain
from quadruped_ctrl_tpu_torch.utils.timer import span

WARMUP_TICKS = 10


def _sensors(cfg, sims):
    return vmap(lambda s: engine.sensors_from_sim(cfg, s))(sims)


def _act(cfg, states, sims, ctx, terrains):
    """leg_commands and the physics step, per lane."""
    states, outs = vmap(lambda st, c: ctrl.leg_commands(cfg, st, c))(states, ctx)
    sims = vmap(lambda sm, o, t: engine.sim_step(cfg, sm, o, t))(sims, outs, terrains)
    return states, sims


def _mpc_tick_batched(cfg, states, sims, cmds, terrains, h_sol,
                      mpc_iterations, max_stance=None, use_kernels=None):
    """The every-13th tick with the MPC solve batch-explicit: control_tick
    and leg_commands per lane, the solve through
    `controller.mpc_update_batched`. With `max_stance` (a valid bound for
    every scenario's gait) the solves run stance-compressed + pair-packed.
    Closed-loop solves are temporally warm-started, so the reduced
    `warm_iterations` budget applies unless the caller overrides it. One
    `qct.mpc_tick` span."""
    with span("qct.mpc_tick"):
        states, ctx = ctrl.control_tick_batched(cfg, states, _sensors(cfg, sims), cmds)
        iters = cfg.solver.warm_iterations if mpc_iterations is None else mpc_iterations
        states = ctrl.mpc_update_batched(cfg, states, ctx, h_sol=h_sol, iterations=iters,
                                         max_stance=max_stance, use_kernels=use_kernels)
        return _act(cfg, states, sims, ctx, terrains)


def _plain_tick(cfg, states, sims, cmds, terrains):
    """A tick without the MPC solve: one `qct.plain_tick` span."""
    with span("qct.plain_tick"):
        states, ctx = ctrl.control_tick_batched(cfg, states, _sensors(cfg, sims), cmds)
        return _act(cfg, states, sims, ctx, terrains)


def batch_init(cfg: FrameworkConfig, terrains: Terrain, batch: int, device=None):
    """Controller and sim initial states for a batch of terrains (leading
    axis `batch`), on `device` (cuda:0 unless named; the terrains lie
    there)."""
    dev = _device.resolve(device)
    states, sims = vmap(lambda t: (ctrl.init_state(cfg, device=dev),
                                   engine.sim_init(cfg, t, device=dev)))(terrains)
    if states.core.safety_ok.shape[0] != batch:
        raise ValueError(f"batch_init: terrains hold {states.core.safety_ok.shape[0]} "
                         f"scenarios, batch={batch}")
    # leaves made without reference to the terrain come out of vmap expanded
    return tree_map(torch.Tensor.contiguous, states), tree_map(torch.Tensor.contiguous, sims)


def batch_rollout(
    cfg: FrameworkConfig,
    states,                 # batched FullControllerState
    sims,                   # batched SimState
    commands: Command,      # batched (leading axis = scenarios)
    terrains: Terrain,      # batched
    n_macro: int,
    mpc_iterations: int | None = None,
    h_sol: int | None = None,
    cont: bool = False,
    max_stance: int | None = None,
    use_kernels: bool | None = None,
):
    """Run n_macro macro-steps (13 ticks each). Returns (states, sims,
    per-macro records: p, v, safety, quat stacked over the macros). `h_sol`
    is the static solved MPC horizon (default cfg.mpc.h_max, always safe).
    `max_stance` enables stance-compressed + packed solves, valid only when
    it bounds every scenario gait's simultaneous stance feet
    (gait.max_simultaneous_stance).

    `cont=True` continues a rollout previously advanced by this function:
    the KF warmup and the pre-first-MPC prologue are skipped so the 13-tick
    MPC cadence is preserved across chunk boundaries.

    `use_kernels` (the port's own) is passed to every MPC solve: None runs
    kernels K1 and K2 on CUDA tensors, False their plain versions."""
    ib = cfg.mpc.iterations_between_mpc

    if not cont:
        for _ in range(WARMUP_TICKS):
            states = vmap(lambda st, sm: ctrl.pre_work(cfg, st, engine.sensors_from_sim(cfg, sm))
                          )(states, sims)
        # prologue: ticks 0..ib-2 run without MPC (first solve at tick ib-1)
        for _ in range(ib - 1):
            states, sims = _plain_tick(cfg, states, sims, commands, terrains)

    def record():
        return dict(p=sims.p, v=sims.v, safety=states.core.safety_ok, quat=sims.quat)

    # n_macro=0 gives empty records of the right shapes, as a scan of length 0
    recs = [tree_map(lambda t: t[None][:0], record())]
    for _ in range(n_macro):
        states, sims = _mpc_tick_batched(cfg, states, sims, commands, terrains, h_sol,
                                         mpc_iterations, max_stance=max_stance,
                                         use_kernels=use_kernels)
        for _ in range(ib - 1):
            states, sims = _plain_tick(cfg, states, sims, commands, terrains)
        recs.append(tree_map(lambda t: t[None], record()))
    return states, sims, tree_map(lambda *xs: torch.cat(xs), *recs)


def sweep_commands(cfg: FrameworkConfig, vx_range, vy_range, wz_range,
                   gaits, batch: int, generator: torch.Generator, device=None):
    """Scenario grid: random (vx, vy, wz, gait) draws from `generator` — the
    terrain x gait x velocity sweep replacing the reference's single
    WalkingSimulation. On `device` (cuda:0 unless named)."""
    dev = _device.resolve(device)
    gdev = generator.device

    def uniform(lo_hi):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(batch, generator=generator, device=gdev)

    vx, vy, wz = uniform(vx_range), uniform(vy_range), uniform(wz_range)
    pick = torch.randint(len(gaits), (batch,), generator=generator, device=gdev)
    g = torch.as_tensor(np.asarray(gaits, np.int32), device=gdev)[pick]
    return Command(
        vel=torch.stack([vx, vy, wz], dim=1).to(dev),
        gait_type=g.to(dev),
        robot_mode=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def batch_terrains(batch: int, generator: torch.Generator, kinds=("plane",),
                   grid=(64, 64), device=None):
    """Batched terrain tree cycling through the requested kinds, on `device`
    (cuda:0 unless named); "random" terrains draw from `generator`.

    A kind of "file:<path>" loads a heightmap file (the reference random2,
    walking_simulation.py:120-130), resampled to the shared `grid`."""
    dev = _device.resolve(device)
    ts = []
    loaded = {}
    for i in range(batch):
        kind = kinds[i % len(kinds)]
        if kind == "plane":
            ts.append(Terrain.plane(grid, device=dev))
        elif kind == "random":
            ts.append(Terrain.random(generator, grid=grid, device=dev))
        elif kind == "stairs":
            ts.append(Terrain.stairs(grid=grid, device=dev))
        elif kind == "slope":
            ts.append(Terrain.slope(grid=grid, device=dev))
        elif kind == "boxes":
            # racetrack-style prop scenario: a low platform straddling the
            # +x path (steppable) and a tall crate offset to the side
            # (worlds/racetrack_day.world:32-45)
            ts.append(Terrain.plane(grid, device=dev).with_boxes(
                centers=[[0.9, 0.0, 0.01], [1.0, 0.6, 0.25]],
                halves=[[0.35, 0.6, 0.01], [0.2, 0.2, 0.25]],
            ))
        elif kind.startswith("file:"):
            path = kind[5:]
            if path not in loaded:
                loaded[path] = Terrain.from_file(path, grid=grid, device=dev)
            ts.append(loaded[path])
        else:
            raise ValueError(kind)
    return tree_map(lambda *xs: torch.stack(xs), *ts)
