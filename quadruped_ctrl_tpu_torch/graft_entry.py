"""Entry points: one controller step of the flagship model, and a multi-rank
dry run of the batched scenario step.

The counterpart of the repo root's `__graft_entry__.py`. `entry()` gives
the full controller step (estimation + gait + MPC-on-cadence + torques)
with example arguments on cuda:0; `dryrun_multichip(n)` runs one batched
scenario step (control tick, the batched MPC solve through kernels K1/128
and K2/128 on the card, leg commands, SRB physics) over an n-rank process
group with the scenario batch sharded across the ranks and an all-reduced
metric: Gloo ranks on the CPU, NCCL ranks on cuda:<rank>.
"""

from __future__ import annotations

import math
import os
import tempfile

import torch
import torch.distributed as dist


def entry(device=None):
    """(fn, example_args): fn(state, sensors, cmd) -> (new_state, tau), the
    full controller step, with example arguments on `device` (cuda:0
    unless named)."""
    from quadruped_ctrl_tpu_torch import device as _device
    from quadruped_ctrl_tpu_torch.config import default_config
    from quadruped_ctrl_tpu_torch.control import controller as ctrl
    from quadruped_ctrl_tpu_torch.core.types import Command
    from quadruped_ctrl_tpu_torch.sim import engine
    from quadruped_ctrl_tpu_torch.sim.terrain import Terrain

    dev = _device.resolve(device)
    cfg = default_config()
    state = ctrl.init_state(cfg, device=dev)
    sim = engine.sim_init(cfg, Terrain.plane(device=dev), device=dev)
    sensors = engine.sensors_from_sim(cfg, sim)
    cmd = Command.create(0.3, 0.0, 0.0, gait_type=9, robot_mode=0, device=dev)

    def fn(state, sensors, cmd):
        new_state, out = ctrl.controller_step(cfg, state, sensors, cmd)
        return new_state, out.tau

    return fn, (state, sensors, cmd)


def _dryrun_step(n_devices: int, dev: torch.device) -> float:
    """One batched scenario step of this rank's shard; returns the
    all-reduced mean |tau| over every rank's scenarios."""
    from quadruped_ctrl_tpu_torch.config import default_config
    from quadruped_ctrl_tpu_torch.control import controller as ctrl
    from quadruped_ctrl_tpu_torch.core.types import Command, vmap
    from quadruped_ctrl_tpu_torch.parallel import mesh as mesh_mod
    from quadruped_ctrl_tpu_torch.sim import batch_rollout as br
    from quadruped_ctrl_tpu_torch.sim import engine

    cfg = default_config(**{"mpc.h_max": 10})
    mp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = mesh_mod.make_mesh(n_devices, mp=mp, device=dev)
    per_dev = 2
    batch = n_devices * per_dev
    terrains = br.batch_terrains(batch, torch.Generator(), device=dev)
    states, sims = br.batch_init(cfg, terrains, batch, device=dev)
    cmds = Command(
        vel=torch.tensor([[0.3, 0.0, 0.0]], device=dev).expand(batch, 3).contiguous(),
        gait_type=torch.full((batch,), 9, dtype=torch.int32, device=dev),
        robot_mode=torch.zeros((batch,), dtype=torch.int32, device=dev))
    states, sims, cmds, terrains = (mesh_mod.shard_batch(t, mesh)
                                    for t in (states, sims, cmds, terrains))

    sensors = vmap(lambda s: engine.sensors_from_sim(cfg, s))(sims)
    states, ctx = ctrl.control_tick_batched(cfg, states, sensors, cmds)
    # the production batched solver path at the PRODUCTION solver budget —
    # full iterations, adaptive rho, and every polish round (one step)
    states = ctrl.mpc_update_batched(cfg, states, ctx)
    states, outs = vmap(lambda st, c: ctrl.leg_commands(cfg, st, c))(states, ctx)
    sims = vmap(lambda sm, o, t: engine.sim_step(cfg, sm, o, t))(sims, outs, terrains)
    taus = outs.tau
    # cross-rank metric reduction over the whole mesh
    stats = torch.stack([taus.abs().sum(),
                         torch.tensor(float(taus.numel()), device=taus.device)])
    dist.all_reduce(stats)
    return float(stats[0] / stats[1])


def _dryrun_rank(rank: int, n_devices: int, port: int, device_type: str, out_path: str):
    """One rank of a launched dry run (torch.multiprocessing.spawn's entry)."""
    from quadruped_ctrl_tpu_torch.parallel.multihost import initialize_distributed

    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if dev.type == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", n_devices, rank, device=dev)
    try:
        mean_tau = _dryrun_step(n_devices, dev)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            f.write(repr(mean_tau))


def dryrun_multichip(n_devices: int, device=None) -> float:
    """Run the batched scenario step once over an n_devices-rank group on
    `device`'s type (cuda unless named; "cpu" for Gloo ranks on the CPU)
    with the scenario batch sharded across the ranks and the mean |tau|
    all-reduced; returns that mean. One rank runs here, on a one-rank
    group; more run as spawned processes, one device each."""
    from quadruped_ctrl_tpu_torch import device as _device
    from quadruped_ctrl_tpu_torch.parallel import mesh as mesh_mod

    dev = _device.resolve(device)
    if n_devices == 1:
        with mesh_mod.local_group(dev):
            mean_tau = _dryrun_step(1, dev)
    else:
        import torch.multiprocessing as tmp

        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "mean_tau")
            tmp.spawn(_dryrun_rank, args=(n_devices, mesh_mod.free_port(), dev.type, out),
                      nprocs=n_devices, join=True)
            with open(out) as f:
                mean_tau = float(f.read())
    if not math.isfinite(mean_tau):
        raise RuntimeError(f"dryrun_multichip: mean |tau| is {mean_tau}")
    return mean_tau
