"""robot_solve_ms_p95: the 95th percentile (nearest rank) over every request
of the window of the host time from a request's call to its forces on the
host."""

import math


def read(ctx):
    xs = sorted(ctx.window["latencies_ms"])
    if not xs:
        return None
    return xs[math.ceil(0.95 * len(xs)) - 1]
