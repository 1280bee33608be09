#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process:

    python3 benchmark/calibrate.py --workload <cell> --first <seed> --seeds <n> \\
        --seconds <s> [--control <k>] [--faults]

runs the cell as `run.py` does (a shorter window, enough to fill the pool's
outputs) for n seeds from `first`, then k seeds with the TF32 control in the
program's place, then (`--faults`) each planted fault on the first three
seeds (`half_batch` not on a batch of one), and prints one JSON line per run with every number the check
computes, compared or not. The control's and the faults' windows stay open
until they have made as many calls as the cell's check samples scenarios
(one per request in the robot cell), so each is judged on a sample like a
timed run's. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run as bench  # noqa: E402
from benchmark.harness import control, spec  # noqa: E402


def full_sample_calls(cell: str) -> int:
    """Calls that give the check a full sample: its scenarios over a batch."""
    c = spec.load_cell(cell)
    return math.ceil(int(c.workload["check"]["scenarios"]) / int(c.traffic["batch"]))


def one(cell: str, seed: int, seconds: float, kind: str, wrap=None, **over) -> dict:
    args = bench.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", "0"])
    result, notes, _, numbers = bench.run(args, entry_wrap=wrap, **over)
    line = dict(cell=cell, seed=seed, kind=kind, correct=result["correct"],
                checks={k: v["value"] for k, v in result["checks"].items()},
                numbers=numbers, metrics={k: v["value"] for k, v in result["metrics"].items()},
                note=notes[0])
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--control-seconds", type=float, default=0.5)
    p.add_argument("--faults", action="store_true")
    a = p.parse_args(argv)
    mpc = spec.load_cell(a.workload).config["mpc"]
    full = full_sample_calls(a.workload)
    for i in range(a.seeds):
        one(a.workload, a.first + i, a.seconds, "program", min_calls=full)
    for i in range(a.control):
        one(a.workload, a.first + i, a.control_seconds, "control_tf32",
            control.tf32_control(mpc), min_calls=full)
    if a.faults:
        one_scenario = int(spec.load_cell(a.workload).traffic["batch"]) == 1
        for name, wrap in control.FAULTS.items():
            if name == "half_batch" and one_scenario:
                continue
            for i in range(3):
                one(a.workload, a.first + i, a.control_seconds, f"fault_{name}", wrap,
                    min_calls=full)
    return 0


if __name__ == "__main__":
    sys.exit(main())
