"""formation_roofline (%): the least time the H100 could take for the
condensed QPs the inputs need, over the device time of the port's packed
formation kernel K1, in the profiled stretch.

Counted per scenario from its gait table, whatever implements it: n stance
forces (3 per stance foot and step), one triangle of the Gram over the 13 h
predicted states, (13 h) n (n + 1) operations; the scenario's inputs read
once (rpy, position, omega, v: 12; feet 12; x_drag 1; reference 13 h; gait
table 4 h floats) and the QP's Hessian (n^2) and gradient (n) written once,
in float32. The bound is the larger of the operations over the bf16
tensor-core peak and the bytes over the HBM rate.
"""

SYMBOLS = ("qct::form_packed_kernel",)


def work(n: int, h: int) -> tuple[int, int]:
    """(operations, bytes) of one scenario's formation."""
    inputs = 12 + 12 + 1 + 13 * h + 4 * h
    return 13 * h * n * (n + 1), 4 * (inputs + n * n + n)


def bound_seconds(batches, peaks: dict) -> float:
    ops = byts = 0
    for b in batches:
        g = b["gait_table"]
        h = int(g.shape[-2])
        for n in (3 * (g > 0.5).sum((-1, -2))).tolist():
            o, by = work(int(n), h)
            ops, byts = ops + o, byts + by
    return max(ops / peaks["bf16_flops"], byts / peaks["hbm_bytes_per_s"])


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.stretch:
        return None
    t = ctx.trace.device_seconds(lambda name: any(s in name for s in SYMBOLS))
    if t <= 0:
        return None
    return 100.0 * bound_seconds(ctx.stretch, ctx.peaks) / t
