"""Host-side timing utilities.

The counterpart of `quadruped_ctrl_tpu/utils/timer.py`, after the
reference's nanosecond Timer (src/Utilities/Timer.h:9-51): a monotonic
scoped timer for the host control loop, plus latency-percentile accounting
for real-time-budget reporting (p50/p99 against the ~30 ms MPC / 2 ms tick
budget). The host clock alone: a caller timing work on the card
synchronizes first."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


class Timer:
    """Monotonic stopwatch (Timer.h API: start/getMs/getNs/getSeconds)."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter_ns()

    def get_ns(self) -> int:
        return time.perf_counter_ns() - self._t0

    def get_ms(self) -> float:
        return self.get_ns() / 1e6

    def get_seconds(self) -> float:
        return self.get_ns() / 1e9


@dataclass
class LatencyRecorder:
    """Collects per-cycle latencies; reports percentiles."""

    samples_ms: list = field(default_factory=list)

    def record(self, ms: float):
        self.samples_ms.append(ms)

    def percentile(self, q: float) -> float:
        if not self.samples_ms:
            return 0.0
        xs = sorted(self.samples_ms)
        idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
        return xs[idx]

    def summary(self) -> dict:
        xs = self.samples_ms
        return {
            "count": len(xs),
            "mean_ms": sum(xs) / len(xs) if xs else 0.0,
            "p50_ms": self.percentile(50),
            "p90_ms": self.percentile(90),
            "p99_ms": self.percentile(99),
            "max_ms": max(xs) if xs else 0.0,
        }


class ScopedTimer:
    """`with ScopedTimer(recorder):` records the block's wall time."""

    def __init__(self, recorder: LatencyRecorder):
        self.recorder = recorder

    def __enter__(self):
        self._timer = Timer()
        return self

    def __exit__(self, *exc):
        self.recorder.record(self._timer.get_ms())
        return False
