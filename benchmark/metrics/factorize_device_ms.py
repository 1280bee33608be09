"""factorize_device_ms (ms/call): the device time of the factorizations.
Reads the port's `qct.factorize` span (`solver/admm.py`: one K build and
its inverse, in the ADMM phase and in each polish round): the device
activities whose launch (the runtime call, paired with its activity by
`harness/spans.launches`) starts inside it, their durations summed, per
call of the profiled stretch. None where the pairing is not exact or the
program has no such span."""

from benchmark.harness import spans


def seconds(trace):
    got = spans.launched_in(trace, "qct.factorize")
    return None if got is None else sum(e - s for _, s, e, _ in got)


def read(ctx):
    return spans.per_call(ctx, seconds, 1e3)
