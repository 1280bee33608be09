"""k2_narrow_share (share): how often the port's K2 at the 256 tile runs on
its 3-CTA instance. K2 (`csrc/ns_refine.cu`, RF_BUILD, mode 4) runs a system
of at most 192 variables on `ns_refine_kernel<192, 4>` (3-CTA clusters over
the tile's leading 192 rows and columns) and a larger one on
`ns_refine_kernel<256, 4>` (4-CTA clusters over all 256). Of the profiled
stretch's launches of either, the share that ran the 192 instance; None
without a trace or without such a launch."""

import re

K2_256 = re.compile(r"ns_refine_kernel<(192|256), 4>")


def read(ctx):
    if ctx.trace is None:
        return None
    widths = [m[1] for m in (K2_256.search(name) for _, _, name in ctx.trace.device) if m]
    return widths.count("192") / len(widths) if widths else None
