"""iterate_resident_share (share): how often the port's ADMM iterate runs as
one resident kernel a segment. `solver/admm.py` wraps each segment of the
batched iterate in a `qct.admm.iterate` span; where the system's inverse
fits on chip, `ops/admm_segment.py` launches `qct::admm_segment_kernel`
inside it (the whole segment, the inverse held in shared memory), else the
iterate runs as plain ops. Of the profiled stretch's `qct.admm.iterate`
spans, the share inside which a runtime call launched
`admm_segment_kernel`; None without a trace or without such a span."""

from benchmark.harness import spans

KERNEL = "admm_segment_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    ivs = [(s, e) for s, e, n in tr.host if n == "qct.admm.iterate"]
    if not ivs:
        return None
    launched = sorted(s for s, _, _, d in tr.runtime if KERNEL in d)
    resident = sum(1 for iv in ivs if any(spans.inside([iv], t) for t in launched))
    return resident / len(ivs)
