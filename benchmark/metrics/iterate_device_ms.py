"""iterate_device_ms (ms/call): the device time of the ADMM iterations.
Reads the port's `qct.admm.iterate` span (`solver/admm.py`, one an ADMM
segment): the device activities whose launch (the runtime call, paired
with its activity by `harness/spans.launches`) starts inside it, their
durations summed, per call of the profiled stretch. None where the pairing
is not exact."""

from benchmark.harness import spans


def seconds(trace):
    got = spans.launched_in(trace, "qct.admm.iterate")
    return None if got is None else sum(e - s for _, s, e, _ in got)


def read(ctx):
    return spans.per_call(ctx, seconds, 1e3)
