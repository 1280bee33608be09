"""route_var_ratio (ratio): the variables the routed solve sets up over the
variables the gait tables need, in the profiled stretch. The port's
`mpc/pipeline.solve_routed_batch` solves each group of a batch in a
`qct.route.bucket n=<variables> b=<scenarios>` span: the sum of n x b over
those spans, over the stretch's stance variables (3 x the stance feet over
the steps of each scenario's gait table). 1.0 where every scenario is
solved at its own count; a solve that took every scenario at the batch's
largest count would read that count over the mean. None without a trace,
without such a span (a program without the router) or without stance
variables."""

import re

from benchmark.harness.spec import metric_reader

stance_variables = metric_reader("factorization_roofline").stance_variables

BUCKET = re.compile(r"^qct\.route\.bucket n=(\d+) b=(\d+)$")


def read(ctx):
    if ctx.trace is None or not ctx.stretch:
        return None
    found = [BUCKET.match(name) for _, _, name in ctx.trace.host]
    set_up = sum(int(m[1]) * int(m[2]) for m in found if m)
    need = sum(sum(stance_variables(b["gait_table"])) for b in ctx.stretch)
    if not set_up or not need:
        return None
    return set_up / need
