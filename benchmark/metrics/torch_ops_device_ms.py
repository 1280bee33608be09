"""torch_ops_device_ms (ms/call): device time of every activity that is not
one of the port's hand-written kernels (namespace `qct::`): PyTorch's own
kernels, cuBLAS, copies and sets, i.e. the ADMM iterate's and the polish's
algebra in `solver/admm.py` and the formation's prologue, per call of the
profiled stretch."""

KERNELS = "qct::"


def read(ctx):
    if ctx.trace is None or ctx.trace.calls <= 0 or not ctx.trace.device:
        return None
    return 1e3 * ctx.trace.device_seconds(lambda n: KERNELS not in n) / ctx.trace.calls
