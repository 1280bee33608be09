"""The port's named spans in a profiled stretch's `Trace`.

The port marks its phases with `record_function` ranges under the prefix
`qct.` (`quadruped_ctrl_tpu_torch/utils/timer.span`): `qct.solve`,
`qct.formation`, `qct.factorize`, `qct.admm.iterate`, ... They are
`user_annotation` events, so `Trace.read` keeps them in `Trace.host`, on the
clock of the device activities. A program without them (an older checkout)
has none, and every function here then finds nothing: the readers built on
them return None.
"""

from __future__ import annotations

import bisect


def intervals(trace, name: str) -> list:
    """The host events called `name`, as disjoint, sorted (start, end): the
    union of their ranges, so a span nested in one of its own name counts
    once."""
    merged = []
    for s, e, n in sorted(trace.host):
        if n != name:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(iv) for iv in merged]


def inside(ivs: list, t: float) -> bool:
    """Whether time t falls in one of the disjoint, sorted intervals ivs."""
    i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
    return i >= 0 and ivs[i][0] <= t <= ivs[i][1]


def idle_intervals(trace) -> list:
    """The device's idle time in the stretch: the complement of
    `busy_intervals()` within (start, end), disjoint and sorted."""
    out, t = [], trace.start
    for s, e in trace.busy_intervals():
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if trace.end > t:
        out.append((t, trace.end))
    return out


def overlap_s(a: list, b: list) -> float:
    """Seconds in both of two lists of disjoint, sorted intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in(trace, name: str) -> float | None:
    """Seconds of device idle time while the host was inside a span called
    `name`; None where the trace has no such span."""
    ivs = intervals(trace, name)
    if not ivs:
        return None
    return overlap_s(idle_intervals(trace), ivs)


def launches(trace) -> list | None:
    """Each device activity with the runtime call that launched it:
    [(runtime start, device start, device end, name)] in launch order.

    The runtime calls that launched an activity (a device name that is not
    empty), sorted by start, are paired in turn with the device activities
    sorted by start: the port runs on one stream, so launch order is
    execution order. `Trace.read` keeps no correlation ids, so the pairing
    is taken only where it is exact: the same number on both sides and the
    same name in every pair; otherwise None."""
    calls = sorted((s, d) for s, _, _, d in trace.runtime if d)
    acts = sorted(trace.device)
    if len(calls) != len(acts):
        return None
    out = []
    for (t, d), (s, e, n) in zip(calls, acts):
        if d != n:
            return None
        out.append((t, s, e, n))
    return out


def launched_in(trace, name: str) -> list | None:
    """The paired launches (see `launches`) whose runtime call starts inside
    a span called `name`; None where the trace has no such span or the
    pairing is not exact."""
    ivs = intervals(trace, name)
    pairs = launches(trace) if ivs else None
    if pairs is None:
        return None
    return [p for p in pairs if inside(ivs, p[0])]


def runtime_in(trace, name: str, match) -> int | None:
    """Runtime calls for which `match(name, device name)` holds that start
    inside a span called `name`; None where the trace has no such span."""
    ivs = intervals(trace, name)
    if not ivs:
        return None
    return sum(1 for s, _, n, d in trace.runtime if match(n, d) and inside(ivs, s))


def per_call(ctx, value, scale: float = 1.0):
    """scale x value(trace) / the stretch's calls, or None: without a trace,
    without device activity (a run on the CPU) or where `value(trace)` is
    None."""
    tr = ctx.trace
    if tr is None or tr.calls <= 0 or not tr.device:
        return None
    v = value(tr)
    return None if v is None else scale * v / tr.calls
