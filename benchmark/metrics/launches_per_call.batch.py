"""launches_per_call.batch (launches/call): device activities (kernels, copies,
sets) per call of the profiled stretch, an exact count: the work the host
dispatches for each call."""


def read(ctx):
    if ctx.trace is None or ctx.trace.calls <= 0 or not ctx.trace.device:
        return None
    return ctx.trace.device_count() / ctx.trace.calls
