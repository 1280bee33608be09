"""route_idle_ms (ms/call): the device's idle time while the host routes a
batch of mixed gaits. Reads the port's `qct.route` span
(`mpc/pipeline.solve_routed_batch`: the grouping of the scenarios by their
stance variables, its one host sync, the groups' gathers and slot lists,
and the forces' scatter back): the time inside it in which no activity ran
on the device, per call of the profiled stretch. None without a trace,
without device activity or without such a span."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_call(ctx, lambda tr: spans.idle_in(tr, "qct.route"), 1e3)
