"""Command-line entry points of the PyTorch port — the counterpart of
`quadruped_ctrl_tpu/cli.py` (the replacement for the reference's ROS
launch/param/topic surface):

    python -m quadruped_ctrl_tpu_torch.cli sim   --gait trot --vx 0.5 --terrain plane
    python -m quadruped_ctrl_tpu_torch.cli sweep --batch 256 --terrains plane,random
    python -m quadruped_ctrl_tpu_torch.cli bench            # MPC solves/s, 8 lanes
    python -m quadruped_ctrl_tpu_torch.cli latency          # control-cycle latency
    python -m quadruped_ctrl_tpu_torch.cli kernels-smoke    # every kernel, production shapes
    python -m quadruped_ctrl_tpu_torch.cli scaling          # data-parallel scaling report

Each runs on cuda:0 unless `--device` names another device (`--device cpu`
runs the plain PyTorch versions on the CPU) and prints the JAX CLI's JSON
line (`kernels-smoke` its case lines); `bench`, `latency`, `kernels-smoke`
and `scaling` write a file only to the path given as `--out`. Gait names
follow the reference numbering
(ConvexMPCLocomotion.cpp:149-172). A YAML config file (--config) overrides
any FrameworkConfig field with dotted keys, e.g. `mpc.horizon: 10`.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

GAITS = {
    "bounding": 1,
    "pronking": 2,
    "standing": 4,
    "trot_running": 5,
    "galloping": 7,
    "pacing": 8,
    "trot": 9,
    "walking": 10,
    "walking2": 11,
}


def load_config(path: str | None, overrides: dict | None = None):
    from quadruped_ctrl_tpu_torch.config import default_config

    kv = {}
    if path:
        import yaml

        with open(path) as f:
            doc = yaml.safe_load(f) or {}

        def flatten(prefix, node):
            for k, v in node.items():
                key = f"{prefix}.{k}" if prefix else k
                if isinstance(v, dict):
                    flatten(key, v)
                else:
                    kv[key] = v

        flatten("", doc)
    if overrides:
        kv.update(overrides)
    return default_config(**kv)


def _trace_ctx(profile_dir: str | None, dev):
    """torch.profiler trace of the host and, on a card, of the device,
    written into `profile_dir` as a Chrome trace (`*.pt.trace.json`, which
    TensorBoard's PyTorch profiler plugin and chrome://tracing read)."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cmd_sim(args):
    import torch

    from quadruped_ctrl_tpu_torch import device as _device
    from quadruped_ctrl_tpu_torch.core.types import Command
    from quadruped_ctrl_tpu_torch.sim import rollout as R
    from quadruped_ctrl_tpu_torch.sim.terrain import Terrain
    from quadruped_ctrl_tpu_torch.utils.metrics import MetricsLogger, tracking_metrics
    from quadruped_ctrl_tpu_torch.utils.timer import Timer

    dev = _device.resolve(args.device)
    cfg = load_config(args.config)
    if args.terrain.startswith("file:"):
        terrain = Terrain.from_file(args.terrain[5:], device=dev)
    else:
        terrain = {
            "plane": lambda: Terrain.plane(device=dev),
            "random": lambda: Terrain.random(torch.Generator().manual_seed(args.seed),
                                             device=dev),
            "stairs": lambda: Terrain.stairs(device=dev),
            "slope": lambda: Terrain.slope(device=dev),
        }[args.terrain]()
    if args.box:
        vals = [[float(v) for v in b.split(",")] for b in args.box]
        if not all(len(v) in (6, 7) for v in vals):
            raise SystemExit("--box cx,cy,cz,hx,hy,hz[,yaw]")
        terrain = terrain.with_boxes(
            centers=[v[:3] for v in vals],
            halves=[v[3:6] for v in vals],
            yaws=[v[6] if len(v) == 7 else 0.0 for v in vals],
        )
    gait = GAITS[args.gait]
    cmd = Command.create(args.vx, args.vy, args.wz, gait_type=gait,
                         robot_mode=args.mode, device=dev)
    timer = Timer()
    with _trace_ctx(args.profile, dev):
        _, sim, traj = R.run_session(cfg, terrain, cmd, n_ticks=args.ticks, device=dev)
        _sync(dev)
    wall = timer.get_seconds()
    m = tracking_metrics(traj, (args.vx, args.vy), cfg.control.body_height)
    m.update(
        ticks=args.ticks,
        sim_seconds=args.ticks * cfg.dt,
        wall_seconds=wall,
        realtime_factor=args.ticks * cfg.dt / wall,
        gait=args.gait,
        terrain=args.terrain,
    )
    MetricsLogger(args.log, echo=True).log(m)
    return 0 if m["safety_ok"] and not m["fell"] else 1


def cmd_sweep(args):
    import torch

    from quadruped_ctrl_tpu_torch import device as _device
    from quadruped_ctrl_tpu_torch.core.types import Command
    from quadruped_ctrl_tpu_torch.gait import gait as gait_mod
    from quadruped_ctrl_tpu_torch.sim import batch_rollout as br
    from quadruped_ctrl_tpu_torch.utils import checkpoint
    from quadruped_ctrl_tpu_torch.utils.metrics import MetricsLogger
    from quadruped_ctrl_tpu_torch.utils.timer import Timer

    dev = _device.resolve(args.device)
    cfg = load_config(args.config)
    gen = torch.Generator().manual_seed(args.seed)
    kinds = tuple(args.terrains.split(","))
    terr = br.batch_terrains(args.batch, gen, kinds=kinds, device=dev)
    states, sims = br.batch_init(cfg, terr, args.batch, device=dev)

    stand = Command(
        vel=torch.zeros((args.batch, 3), dtype=torch.float32, device=dev),
        gait_type=torch.full((args.batch,), 9, dtype=torch.int32, device=dev),
        robot_mode=torch.ones((args.batch,), dtype=torch.int32, device=dev),
    )
    gait_list = [GAITS[g] for g in args.gaits.split(",")]
    cmds = br.sweep_commands(
        cfg, (0.0, args.vx_max), (-0.3, 0.3), (-0.5, 0.5),
        gait_list, args.batch, gen, device=dev,
    )
    # stance compression + pair packing (the bench pipeline's solve shape,
    # controller._mpc_update_batched_packed) whenever the static gait list
    # guarantees the bound; 2-stance gaits (trot family) get the full 8x
    # factorization shrink. The mode-1 stand phase is 4-stance (aio standing
    # band) and always solves uncompressed.
    max_stance = gait_mod.max_simultaneous_stance(gait_list)
    max_stance = None if (args.no_compress or max_stance >= 4) else max_stance
    ckpt = args.checkpoint
    if ckpt and not ckpt.endswith(".npz"):
        ckpt += ".npz"
    every = args.checkpoint_every or args.macros

    def scalar(v, dtype):
        return torch.full((), v, dtype=dtype, device=dev)

    example = {"states": states, "sims": sims,
               "done": scalar(0, torch.int32), "wall": scalar(0.0, torch.float32)}
    # resume guard: a checkpoint written under different sweep parameters
    # (seed/terrains/gaits/config) would silently continue the wrong run
    fingerprint = {
        "seed": args.seed, "terrains": args.terrains, "gaits": args.gaits,
        "batch": args.batch, "vx_max": args.vx_max, "h_sol": args.h_sol,
        "max_stance": max_stance, "config": repr(cfg),
    }

    # h_sol=10: the mode-1 stand phase runs the aio standing band (h=10) and
    # the mode-0 sweep keeps the sticky horizonLength 10 (see
    # LocomotionState.mpc_h) — so the 120-var packed KKT systems fit the
    # 128 kernel tile. Raise via --h-sol for custom mode-1 sweeps.
    timer = Timer()
    done = 0
    prev_wall = 0.0
    if ckpt and os.path.exists(ckpt):
        payload = checkpoint.load(ckpt, example, fingerprint=fingerprint)
        states, sims = payload["states"], payload["sims"]
        done = int(payload["done"])
        prev_wall = float(payload["wall"])
        print(f"# resumed {ckpt} at macro {done}/{args.macros}")
    else:
        states, sims, _ = br.batch_rollout(
            cfg, states, sims, stand, terr, 16, h_sol=args.h_sol
        )
    recs = None
    while done < args.macros:
        n = min(every, args.macros - done)
        states, sims, recs = br.batch_rollout(
            cfg, states, sims, cmds, terr, n, h_sol=args.h_sol,
            cont=done > 0, max_stance=max_stance,
        )
        done += n
        if ckpt:
            _sync(dev)
            checkpoint.save(
                ckpt, {"states": states, "sims": sims,
                       "done": scalar(done, torch.int32),
                       "wall": scalar(prev_wall + timer.get_seconds(), torch.float32)},
                fingerprint=fingerprint,
            )
    if recs is not None:
        p_final = recs["p"][-1].cpu().numpy()
        safety = recs["safety"][-1].cpu().numpy()
    else:  # resumed at done == macros: read the checkpointed final state
        p_final = sims.p.cpu().numpy()
        safety = states.core.safety_ok.cpu().numpy()
    upright = p_final[:, 2] > 0.12
    # wall/ticks cover the whole sweep including any previous (checkpointed)
    # invocations, so robot_ticks_per_s stays honest across resumes
    wall = prev_wall + timer.get_seconds()
    ticks = (16 + args.macros) * cfg.mpc.iterations_between_mpc
    m = {
        "batch": args.batch,
        "macros": args.macros,
        "survival_rate": float(upright.mean()),
        "safety_rate": float(safety.mean()),
        "wall_seconds": wall,
        "robot_ticks_per_s": args.batch * ticks / wall,
        "terrains": args.terrains,
        "max_stance": max_stance,
    }
    MetricsLogger(args.log, echo=True).log(m)
    return 0


def cmd_bench(args):
    from quadruped_ctrl_tpu_torch import bench
    from quadruped_ctrl_tpu_torch import device as _device

    dev = _device.resolve(args.device)
    with _trace_ctx(args.profile, dev):
        bench.main(batch=args.batch, batch16=args.batch16, n_reps=args.reps,
                   n_reps16=args.reps16, device=dev, out=args.out)
    return 0


def cmd_latency(args):
    from quadruped_ctrl_tpu_torch import bench_latency

    bench_latency.main(ticks=args.ticks, macros=args.macros, device=args.device,
                       out=args.out)
    return 0


def cmd_kernels_smoke(args):
    """Run every kernel of the port at production (batch, tile) shapes on the
    device. Non-zero exit on any failure; artifact via --out."""
    import torch

    from quadruped_ctrl_tpu_torch import device as _device
    from quadruped_ctrl_tpu_torch.utils import kernels_smoke

    dev = _device.resolve(args.device)
    where = (f"{torch.cuda.get_device_name(dev)} ({dev})" if dev.type == "cuda"
             else "cpu: the kernels' plain PyTorch versions")
    header = (f"kernel smoke: device={where}\n"
              "# times are the wall clock of one synchronised call, best of 2 "
              "after a warm-up; the gate is launch+finiteness+residual; "
              "per-solve device timing lives in the bench command")
    print(header, flush=True)
    lines, failed = kernels_smoke.run_smoke(full=args.full, device=dev)
    tail = f"{len(lines)} cases, {failed} failed"
    print(tail)
    if args.out:
        with open(args.out, "w") as f:
            f.write(header + "\n" + "\n".join(lines) + "\n" + tail + "\n")
    return 1 if failed else 0


def cmd_scaling(args):
    import json

    from quadruped_ctrl_tpu_torch.parallel import multihost

    cfg = load_config(args.config)
    rep = multihost.scaling_report(
        cfg, per_device_batch=args.per_device_batch, reps=args.reps, device=args.device
    )
    if args.multiprocess:
        rep["multiprocess"] = multihost.multiprocess_scaling(
            num_processes=args.multiprocess,
            per_device_batch=args.per_device_batch, reps=args.reps,
        )
    out = json.dumps(rep)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="quadruped_ctrl_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    s = sub.add_parser("sim", help="single-robot closed-loop session")
    s.add_argument("--gait", default="trot", choices=sorted(GAITS))
    s.add_argument("--terrain", default="plane",
                   help="plane | random | stairs | slope | file:<heightmap>"
                        " (.txt/.npy/image; the reference random2)")
    s.add_argument("--box", action="append", default=[],
                   metavar="CX,CY,CZ,HX,HY,HZ[,YAW]",
                   help="add a solid box prop (repeatable; racetrack-style "
                        "collision obstacle)")
    s.add_argument("--vx", type=float, default=0.5)
    s.add_argument("--vy", type=float, default=0.0)
    s.add_argument("--wz", type=float, default=0.0)
    s.add_argument("--mode", type=int, default=0, choices=[0, 1])
    s.add_argument("--ticks", type=int, default=2500)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--config", default=None)
    s.add_argument("--log", default=None)
    s.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace into DIR")
    s.add_argument("--device", default=None,
                   help="torch device to run on (default cuda:0)")
    s.set_defaults(fn=cmd_sim)

    s = sub.add_parser("sweep", help="batched scenario sweep")
    s.add_argument("--batch", type=int, default=64)
    s.add_argument("--macros", type=int, default=150)
    s.add_argument("--terrains", default="plane")
    s.add_argument("--gaits", default="trot")
    s.add_argument("--vx-max", type=float, default=1.0)
    s.add_argument("--h-sol", type=int, default=10,
                   help="static solved MPC horizon (mode-0 sweeps keep the "
                        "sticky horizonLength 10; raise for mode-1 sweeps)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--config", default=None)
    s.add_argument("--log", default=None)
    s.add_argument("--checkpoint", default=None,
                   help="save/resume the (controller, sim) tree here after "
                        "every --checkpoint-every macros; if the file exists "
                        "the sweep resumes from it")
    s.add_argument("--checkpoint-every", type=int, default=0,
                   help="macro-steps between checkpoints (0 = only at end)")
    s.add_argument("--no-compress", action="store_true",
                   help="disable stance compression + packing even when the "
                        "gait list permits it (debug/ablation)")
    s.add_argument("--device", default=None,
                   help="torch device to run on (default cuda:0)")
    s.set_defaults(fn=cmd_sweep)

    s = sub.add_parser("bench", help="MPC solves/s benchmark")
    s.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace into DIR")
    s.add_argument("--batch", type=int, default=4096, help="h=10 lanes' batch")
    s.add_argument("--batch16", type=int, default=2048, help="h=16 lanes' batch")
    s.add_argument("--reps", type=int, default=48, help="h=10 lanes' chained reps")
    s.add_argument("--reps16", type=int, default=16, help="h=16 lanes' chained reps")
    s.add_argument("--out", default=None, help="also write the JSON here")
    s.add_argument("--device", default=None,
                   help="torch device to run on (default cuda:0)")
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("latency", help="control-cycle latency benchmark")
    s.add_argument("--ticks", type=int, default=200,
                   help="timed round trips, of a tick and of the launch+copy pair")
    s.add_argument("--macros", type=int, default=40, help="13-tick macro-cycles timed")
    s.add_argument("--out", default=None, help="also write the JSON here")
    s.add_argument("--device", default=None,
                   help="torch device to run on (default cuda:0)")
    s.set_defaults(fn=cmd_latency)

    s = sub.add_parser(
        "kernels-smoke",
        help="run every kernel at production shapes (on-device gate; --out "
             "records the artifact)")
    s.add_argument("--out", default=None)
    s.add_argument("--full", action="store_true", default=None,
                   help="force production batches (default: on the card only)")
    s.add_argument("--device", default=None,
                   help="torch device to run on (default cuda:0)")
    s.set_defaults(fn=cmd_kernels_smoke)

    s = sub.add_parser("scaling", help="multi-device scaling-efficiency report")
    s.add_argument("--per-device-batch", type=int, default=256)
    s.add_argument("--reps", type=int, default=3)
    s.add_argument("--multiprocess", type=int, default=0,
                   help="also measure N-process torch.distributed weak scaling "
                        "(CPU harness for the multi-host axis)")
    s.add_argument("--out", default=None, help="also write the JSON here")
    s.add_argument("--config", default=None)
    s.add_argument("--device", default=None,
                   help="torch device to run on (default cuda:0)")
    s.set_defaults(fn=cmd_scaling)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
