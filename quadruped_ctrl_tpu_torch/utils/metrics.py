"""Structured metrics & jsonl logging.

The counterpart of `quadruped_ctrl_tpu/utils/metrics.py`: in place of the
reference's observability surface (six ROS topics + printf/rospy.loginfo
scattered through the C++), structured records — solves/s, per-stage times,
cycle-latency percentiles, tracking errors, safety flags — appended as one
JSON object per line.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


class MetricsLogger:
    def __init__(self, path: str | None = None, echo: bool = False):
        self.path = Path(path) if path else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, record: dict):
        record = {"t": time.time(), **record}
        line = json.dumps(record, default=float)
        if self.path:
            with self.path.open("a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line)
        return record


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def tracking_metrics(traj, v_cmd, body_height: float) -> dict:
    """Summarize a rollout trajectory dict (from sim.rollout): the tail is
    its second half."""
    v = _host(traj["v"])
    p = _host(traj["p"])
    rpy = _host(traj["rpy"])
    tail = slice(len(v) // 2, None)
    return {
        "vx_mean": float(v[tail, 0].mean()),
        "vx_err": float(abs(v[tail, 0].mean() - v_cmd[0])),
        "vy_err": float(abs(v[tail, 1].mean() - v_cmd[1])),
        "height_mean": float(p[tail, 2].mean()),
        "height_err": float(abs(p[tail, 2].mean() - body_height)),
        "rpy_max": float(np.abs(rpy[tail]).max()),
        "safety_ok": bool(_host(traj["safety"])[-1]),
        "fell": bool(p[:, 2].min() < 0.1),
    }
