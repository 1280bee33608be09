"""solve_syncs_per_call.batch (syncs/call): the host syncs the solve makes
itself. Reads the port's `qct.solve` span (`mpc/pipeline.solve_packed_batch`
and `pipeline.solve`): the CUDA runtime calls that make the host wait for
the device (`syncs_per_call.robot`'s `blocking`: synchronizes, blocking
copies) that start inside it, per call of the profiled stretch. The
harness's own copies of the forces to the host lie outside the span."""

from benchmark.harness import spans
from benchmark.harness.spec import metric_reader

blocking = metric_reader("syncs_per_call.robot").blocking


def read(ctx):
    return spans.per_call(ctx, lambda tr: spans.runtime_in(tr, "qct.solve", blocking))
