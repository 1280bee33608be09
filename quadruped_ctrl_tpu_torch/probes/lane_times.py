"""Time the h=16 lanes of one checkout end to end on the card.

    python3 quadruped_ctrl_tpu_torch/probes/lane_times.py [--root DIR] [--label NAME]

`--root` is the root of the checkout whose `quadruped_ctrl_tpu_torch` and
`chip_smoke.py` helpers are imported (default: this one); run it on two
checkouts in one call, in turns (A, B, B, A), to compare them on one card.
For h16_full, h16_trot and h16_midband (chip_smoke.LANES16, batch 2048,
random_inputs(seed=1)) and h16_woodbury (h16_full's inputs under
chip_smoke.woodbury_config) it prints `solve_packed_batch`'s ms per call
(host clock, median of 5 synchronized calls after a warm-up) and, from
chip_smoke.phase_profile, the device busy time and idle share of one solve
and its largest device items. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke as cs
    from quadruped_ctrl_tpu_torch import default_config
    from quadruped_ctrl_tpu_torch.mpc import pipeline
    from quadruped_ctrl_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("lane_times: needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    _build.load()
    print(f"{args.label}: {cs.__file__}; {card}")
    cfg = default_config()
    out = {"label": args.label, "card": card}
    lanes = {**{lane: (cfg, *v) for lane, v in cs.LANES16.items()},
             "h16_woodbury": (cs.woodbury_config(cfg), *cs.LANES16["h16_full"])}
    for lane, (lane_cfg, ms, pack, kind) in lanes.items():
        inputs = cs.lane_inputs(1, cs.B16, cs.H16, kind, dev)
        call_ms = cs.median_ms(lambda: pipeline.solve_packed_batch(
            lane_cfg, inputs, max_stance=ms, pack=pack), reps=5)
        prof = cs.phase_profile(lane_cfg, lane, inputs, max_stance=ms, pack=pack)
        out[lane] = dict(ms_per_call=call_ms, **prof)
        print(f"  {lane}: {call_ms:.2f} ms per call (median of 5)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
