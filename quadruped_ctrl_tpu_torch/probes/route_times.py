"""The routed solve against the unrouted control on the card, on the
benchmark cell `h14_gait_mix_solve`'s traffic.

    python3 quadruped_ctrl_tpu_torch/probes/route_times.py [--seconds 8] [--seed N]

Draws a pool of 16 batches as the cell draws its pool (9,216 scenarios a
batch, 1,024 of each mode-0 gait at h=14; `benchmark/traffic/gait_mix.py`),
warms both solves up, then times in turns (routed, unrouted, routed,
unrouted) back-to-back calls over `--seconds` each, with no sync inside a
timed stretch but the one after its last call:
- routed: `pipeline.solve_routed_batch(cfg, inputs)`, each scenario at its
  own count of stance variables (72 / 84 / 120 / 168);
- unrouted: `pipeline.solve_packed_batch(cfg, inputs, max_stance=4,
  pack=1)`, the only batched solve of such a batch without the router:
  every scenario at 168 variables on K2/192.
Prints solves/s a stretch; the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

CELL = "h14_gait_mix_solve"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=3_000_000_777)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from benchmark.harness import spec
    from quadruped_ctrl_tpu_torch.mpc import pipeline
    from quadruped_ctrl_tpu_torch.ops import _build

    _build.load()
    cell = spec.load_cell(CELL)
    cfg = spec.program_config(cell.config)
    h = int(cell.config["horizon"])
    pool = cell.generator().make_pool(dict(cell.traffic, pool=16), h, args.seed,
                                      torch.device("cuda", 0))
    inputs = [pipeline.MPCInputs(**b) for b in pool]
    batch = inputs[0].rpy.shape[0]
    solves = {"routed": lambda i: pipeline.solve_routed_batch(cfg, i),
              "unrouted": lambda i: pipeline.solve_packed_batch(cfg, i, max_stance=4, pack=1)}
    for solve in solves.values():
        solve(inputs[0])
    torch.cuda.synchronize()
    out = {}
    for name in ("routed", "unrouted", "routed", "unrouted"):
        t0, k = time.perf_counter(), 0
        while time.perf_counter() - t0 < args.seconds:
            solves[name](inputs[k % len(inputs)])
            k += 1
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        out.setdefault(name, []).append(k * batch / t)
        print(f"{name}: {k} calls in {t:.3f} s, {k * batch / t:.2f} solves/s", flush=True)
    out["ratio"] = min(out["routed"]) / max(out["unrouted"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
