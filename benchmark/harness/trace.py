"""One profiled stretch of a run, read from torch.profiler's trace.

`profiled()` wraps a stretch of calls in `torch.profiler` (CPU and CUDA
activities) and a `bench.stretch` range; `read_profile` exports it once the
window has closed, and `Trace.read` parses the Chrome trace into device
activities (kernels, copies, sets), the CUDA runtime's calls and the host's
operators, all on one clock. The
reductions here (busy time, idle gaps named by what the host was doing) are
the arithmetic of `chip_smoke.py`'s `phase_profile`, taken over the
stretch.
"""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass, field

STRETCH = "bench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclass
class Trace:
    """Seconds throughout. `device`: (start, end, name) of every device
    activity in the stretch; `runtime`: (start, end, name, device name) of
    every CUDA runtime or driver call, with the name of the device activity
    it launched ("" if none); `host`: (start, end, name) of every host event
    but the stretch's own range; `start`, `end`: the stretch."""

    start: float
    end: float
    calls: int
    device: list = field(default_factory=list)
    runtime: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @classmethod
    def read(cls, path: str, calls: int) -> "Trace":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        stretch = [e for e in events if e.get("name") == STRETCH
                   and e.get("cat") == "user_annotation"]
        if len(stretch) != 1:
            raise RuntimeError(f"trace: {len(stretch)} '{STRETCH}' ranges, expected 1")
        s0 = float(stretch[0]["ts"]) * 1e-6
        s1 = s0 + float(stretch[0]["dur"]) * 1e-6
        tr = cls(start=s0, end=s1, calls=calls)
        launched, calls_rt = {}, []
        for e in events:
            if e.get("ph") != "X" or e is stretch[0]:
                continue
            t0 = float(e["ts"]) * 1e-6
            item = (t0, t0 + float(e.get("dur", 0.0)) * 1e-6, str(e.get("name", "")))
            cat = e.get("cat")
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                tr.device.append(item)
                launched[corr] = item[2]
            elif cat in HOST_CATS:
                tr.host.append(item)
                if cat in ("cuda_runtime", "cuda_driver"):
                    calls_rt.append((item, corr))
        tr.runtime = [item + (launched.get(corr, "") if corr is not None else "",)
                      for item, corr in calls_rt]
        tr.device.sort()
        tr.host.sort()
        return tr

    def busy_intervals(self) -> list:
        """The device's busy time as disjoint (start, end), clipped to the
        stretch."""
        merged = []
        for s, e, _ in self.device:
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_seconds(self, match) -> float:
        """Seconds of the device activities whose name `match` accepts."""
        return sum(e - s for s, e, n in self.device if match(n))

    def device_count(self) -> int:
        return len(self.device)

    def runtime_count(self, match) -> int:
        """Runtime calls for which `match(name, device name)` holds."""
        return sum(1 for _, _, n, d in self.runtime if match(n, d))

    def top_device_ops(self, k: int = 10) -> list:
        by = {}
        for s, e, n in self.device:
            by[n[:200]] = by.get(n[:200], 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time in the stretch, by the host event that was
        running at each gap's midpoint (the innermost one), summed by name:
        the k names with the most."""
        gaps, t = [], self.start
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        by, active, i = {}, [], 0
        for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (g0 + g1) / 2
            while i < len(self.host) and self.host[i][0] <= mid:
                active.append(self.host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            name = min(active, key=lambda h: h[1] - h[0])[2] if active else "(no host event)"
            by[name[:200]] = by.get(name[:200], 0.0) + (g1 - g0)
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


@contextlib.contextmanager
def profiled(sync, out: dict):
    """Profile the body as one stretch; `sync()` ends it. On exit
    `out["profile"]` holds the profiler, for `read_profile` after the
    window (exporting and parsing it takes seconds, which would otherwise
    come out of the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            yield
            sync()
    out["profile"] = prof


def read_profile(prof, tmpdir: str, calls: int) -> Trace:
    """The `Trace` of a finished profile of `calls` calls; the exported
    file is gone on return."""
    path = os.path.join(tmpdir, f"bench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        return Trace.read(path, calls)
    finally:
        os.unlink(path)
