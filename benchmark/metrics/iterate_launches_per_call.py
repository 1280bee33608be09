"""iterate_launches_per_call (launches/call): the device work the host
dispatches for the ADMM iterations. Reads the port's `qct.admm.iterate`
span (`solver/admm.py`, one an ADMM segment): the runtime calls that
launched a device activity (kernel, copy, set) and start inside it, per
call of the profiled stretch."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_call(ctx, lambda tr: spans.runtime_in(
        tr, "qct.admm.iterate", lambda name, device_name: bool(device_name)))
