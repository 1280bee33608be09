"""Where the closed loop's host time goes, on the card.

    python3 quadruped_ctrl_tpu_torch/probes/loop_times.py [--batch 4096] [--macros 6]

Builds the kernels, sets up `chip_smoke.py` phase 4e's sweep (the plane,
stand command in mode 1, `sweep_commands` from a Generator seeded 0), runs
4 stand macros and then `--macros` sweep macros one `batch_rollout` call
each, and prints each macro's host time (synchronized), then the same
macros as one call with Python's garbage collector on and off. Then, from the
sweep's end, it times a plain tick and an MPC tick three ways: the host
clock with a synchronize after each call, the host clock over 10 chained
calls, and CUDA events over the same chained calls. Last, torch.profiler
over one plain tick and one MPC tick: the count of each CUDA runtime call
the host made (launches, copies, synchronizations) and the host ops with
the most self time. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--macros", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from quadruped_ctrl_tpu_torch import default_config
    from quadruped_ctrl_tpu_torch.core.types import Command
    from quadruped_ctrl_tpu_torch.ops import _build
    from quadruped_ctrl_tpu_torch.sim import batch_rollout as br

    if not torch.cuda.is_available():
        raise SystemExit("loop_times: needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    _build.build()
    _build.load()
    cfg = default_config()
    b, h = args.batch, cs.CL_H
    gen = torch.Generator().manual_seed(0)
    terr = br.batch_terrains(b, gen, device=dev)
    states, sims = br.batch_init(cfg, terr, b, device=dev)
    stand = Command(vel=torch.zeros((b, 3), device=dev),
                    gait_type=torch.full((b,), 9, dtype=torch.int32, device=dev),
                    robot_mode=torch.ones((b,), dtype=torch.int32, device=dev))
    sweep = br.sweep_commands(cfg, (0.0, 1.0), (-0.3, 0.3), (-0.5, 0.5), [9], b, gen,
                              device=dev)
    out = dict(card=card, batch=b)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    s, m = states, sims
    macro_ms = {"stand": [], "sweep": []}
    for i in range(4):
        (s, m, _), ms = timed(lambda: br.batch_rollout(cfg, s, m, stand, terr, 1, h_sol=h,
                                                       cont=i > 0))
        macro_ms["stand"].append(ms)
    for _ in range(args.macros):
        (s, m, _), ms = timed(lambda: br.batch_rollout(cfg, s, m, sweep, terr, 1, h_sol=h,
                                                       cont=True, max_stance=cs.MS))
        macro_ms["sweep"].append(ms)
    print("  macro ms by host clock (synchronized): " + ", ".join(
        f"{k} " + " ".join(f"{v:.1f}" for v in vs) for k, vs in macro_ms.items()))
    out["macro_ms"] = macro_ms
    # the same sweep macros as one call, as chip_smoke.py runs them, with
    # Python's cyclic garbage collector on and then off
    for label in ("one_call", "one_call_gc_off"):
        if label.endswith("gc_off"):
            gc.disable()
        gc_ms = []

        def on_gc(phase, info, t=[0.0]):
            if phase == "start":
                t[0] = time.perf_counter()
            else:
                gc_ms.append((time.perf_counter() - t[0]) * 1e3)

        gc.callbacks.append(on_gc)
        try:
            _, ms = timed(lambda: br.batch_rollout(cfg, s, m, sweep, terr, args.macros,
                                                   h_sol=h, cont=True, max_stance=cs.MS))
        finally:
            gc.callbacks.remove(on_gc)
            gc.enable()
        out[label] = dict(ms_per_macro=ms / args.macros, gc_runs=len(gc_ms),
                          gc_ms=sum(gc_ms))
        print(f"  {args.macros} sweep macros in one call ({label}): {ms / args.macros:.1f} ms a "
              f"macro; {len(gc_ms)} garbage collections, {sum(gc_ms):.1f} ms in them")

    ticks = {"plain": lambda: br._plain_tick(cfg, s, m, sweep, terr),
             "mpc": lambda: br._mpc_tick_batched(cfg, s, m, sweep, terr, h, None,
                                                 max_stance=cs.MS)}
    for name, fn in ticks.items():
        synced = statistics.median(timed(fn)[1] for _ in range(10))
        _, chained = timed(lambda: [fn() for _ in range(10)])
        ev = cs.event_ms(fn, n=10)
        out[f"{name}_tick_ms"] = dict(synced=synced, chained=chained / 10, events=ev)
        print(f"  {name} tick: {synced:.2f} ms synchronized after each call (median of 10), "
              f"{chained / 10:.2f} ms chained (host clock), {ev:.2f} ms chained (events)")

    for name, fn in ticks.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        runtime, ops = {}, {}
        for e in prof.key_averages():
            if e.key.startswith("cuda") or e.key.startswith("cu"):
                runtime[e.key] = (e.count, e.self_cpu_time_total / 1e3)
            elif e.self_cpu_time_total > 0:
                ops[e.key] = (e.count, e.self_cpu_time_total / 1e3)
        top_rt = sorted(runtime.items(), key=lambda kv: -kv[1][1])[:8]
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])[:12]
        print(f"  {name} tick under the profiler: CUDA runtime calls (count, host ms):")
        for k, (c, t) in top_rt:
            print(f"    {c:6d} {t:9.3f}  {k}")
        print(f"  {name} tick: host ops with the most self time (count, ms):")
        for k, (c, t) in top_ops:
            print(f"    {c:6d} {t:9.3f}  {k[:70]}")
        out[f"{name}_runtime_calls"] = {k: v for k, v in top_rt}
        out[f"{name}_host_ops"] = {k[:70]: v for k, v in top_ops}
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
