"""formation_idle_ms (ms/call): the device's idle time while the host forms
the QP. Reads the port's `qct.formation` span (`mpc/pipeline`: dynamics,
discretization, stance selection, the packed QP up to its Hessian and
gradient): the time inside it in which no activity ran on the device, per
call of the profiled stretch."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_call(ctx, lambda tr: spans.idle_in(tr, "qct.formation"), 1e3)
