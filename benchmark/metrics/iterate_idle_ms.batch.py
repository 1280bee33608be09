"""iterate_idle_ms.batch (ms/call): the device's idle time while the host
dispatches the ADMM iterations. Reads the port's `qct.admm.iterate` span
(`solver/admm.py`, one an ADMM segment): the time inside it in which no
activity ran on the device, per call of the profiled stretch."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_call(ctx, lambda tr: spans.idle_in(tr, "qct.admm.iterate"), 1e3)
