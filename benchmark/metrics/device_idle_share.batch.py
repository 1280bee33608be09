"""device_idle_share.batch (share): the part of the profiled stretch (from its first
call's submission to the synchronize after its last) in which no activity
ran on the device. The profiler's own host work widens the stretch, so this
is an upper bound."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or ctx.trace.window_s <= 0:
        return None
    return 1.0 - ctx.trace.busy_s / ctx.trace.window_s
