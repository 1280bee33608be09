"""factorization_roofline (%): the least time the H100 could take for the
factorizations the inputs need, over the device time of the port's
factorization kernels (K2, K3 and the persistent wgmma step), in the
profiled stretch.

The work is counted from the gait tables, whatever implements it: n is a
scenario's stance forces (3 per stance foot and step; packing, tile padding
and swing slots are not counted), and each factorization the solver
settings call for (rho_adapt + 1 in the ADMM phase, one per polish round)
is a classical dense inverse: 2 n^3 operations, the n x n float32 matrix
read once and its inverse written once. The bound is the larger of the
operations over the bf16 tensor-core peak and the bytes over the HBM rate.
"""

SYMBOLS = ("qct::ns_inverse_scaled_build_kernel", "qct::ns_inverse_scaled_kernel",
           "qct::ns_refine_kernel")


def factorizations(solver: dict) -> int:
    return int(solver["rho_adapt"]) + 1 + int(solver["polish_rounds"])


def work(n: int, count: int) -> tuple[int, int]:
    """(operations, bytes) of `count` factorizations of one n-variable QP."""
    return count * 2 * n ** 3, count * 2 * n * n * 4


def stance_variables(gait_table) -> list[int]:
    """3 x the stance feet over the steps, per scenario of (S, h, 4)."""
    return [int(v) for v in (3 * (gait_table > 0.5).sum((-1, -2))).tolist()]


def bound_seconds(batches, solver: dict, peaks: dict) -> float:
    count = factorizations(solver)
    ops = byts = 0
    for b in batches:
        for n in stance_variables(b["gait_table"]):
            o, by = work(n, count)
            ops, byts = ops + o, byts + by
    return max(ops / peaks["bf16_flops"], byts / peaks["hbm_bytes_per_s"])


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.stretch:
        return None
    t = ctx.trace.device_seconds(lambda name: any(s in name for s in SYMBOLS))
    if t <= 0:
        return None
    return 100.0 * bound_seconds(ctx.stretch, ctx.cell.config["solver"], ctx.peaks) / t
