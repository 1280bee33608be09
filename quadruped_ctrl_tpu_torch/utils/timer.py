"""Host-side timing utilities.

The counterpart of `quadruped_ctrl_tpu/utils/timer.py`, after the
reference's nanosecond Timer (src/Utilities/Timer.h:9-51): a monotonic
stopwatch for the host control loop, plus latency-percentile accounting
for real-time-budget reporting (p50/p99 against the ~30 ms MPC / 2 ms tick
budget). The host clock alone: a caller timing work on the card
synchronizes first.

`span(name)` marks a phase of the port on torch.profiler's clock, the one
its device activities are on, whenever a profiler records (the benchmark's
traced stretch, `cli ... --profile DIR`, an operator's own profile); with
none it does nothing. The port's spans, all under the prefix `qct.`:

* `qct.solve`, around `mpc/pipeline.solve`, `solve_compressed` and
  `solve_packed_batch`, and inside it `qct.formation` (dynamics,
  discretization, stance selection, the QP up to its Hessian and gradient);
* in `solver/admm.py`: `qct.factorize` (one K build and NS inverse),
  `qct.admm.iterate` (one ADMM segment), `qct.admm.rho_adapt` (the
  adaptive-rho step, its refactorization nested) and `qct.admm.polish` (one
  polish round, its factorization nested);
* `qct.ops.<wrapper>`, around each kernel wrapper of `ops/`: its checks,
  alignment copies and launch;
* `qct.controller_step` with `qct.control_tick`, `qct.mpc_update` and
  `qct.leg_commands` (`control/controller.controller_step`), and
  `qct.mpc_tick`, `qct.plain_tick` (`sim/batch_rollout`).

No span opens inside a per-iteration loop."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """`with span("qct.<phase>"):` a `record_function` range while a
    torch.profiler records, else one shared no-op context (an unguarded
    range costs the host its construction even with no profiler on)."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _OFF


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

