"""The batched ADMM segment kernel (`csrc/admm_segment.cu`, through
`ops/admm_segment.admm_segment`) on the card, on a real call of each cell
that runs it: `h16_full_solve` (192 variables), `h16_midband_solve` (144)
and `h10_trot_solve` (120, two scenarios a system), their traffic and
configuration drawn as `benchmark/run.py` draws them. The `card` tests skip
without a card. This file imports no JAX, so they run where JAX is absent:

    python3 -m pytest --noconftest -p no:cacheprovider -q -m card tests/test_torch_admm_segment_card.py

What is compared, and why so. The kernel sums its two matrix products in
another order than cuBLAS does. In fp32 products that moves an iterate by
rounding: a 60-iteration fp32 segment on the card holds the eager loop
(`admm_segment_reference`) within 1e-4 of each system's largest entry
(measured at most 3.9e-5, as far as the eager loop on the CPU is from the
eager loop on the card). In the bf16 iterations a difference of one fp32
unit in rhs now and then rounds rhs to the neighbouring bf16 value, and
over 60 iterations that spreads to ~2-3% of a system's largest entry at the
median: the eager loop on the CPU is as far from the eager loop on the card
(measured: kernel and CPU each 0.017-0.026 at the median, 0.05-0.07 at the
90th percentile, 0.11-0.26 at the largest over 256 systems; at n = 120 the
kernel equals the CPU's loop bit for bit). So the solver's segments are held
to three times the CPU's distance from the card's loop at each of those
quantiles, and the forces to `benchmark/harness/check.py`'s `correct` under
the cell's limits, and to the eager loop's forces within 0.25 N at the
median scenario and 0.5 N at the 90th percentile (measured 0.043-0.050 N
and 0.094-0.127 N; the polish settles the few knife-edge scenarios on
nearby active sets either way).
"""

import pytest
import torch

from benchmark.harness import check, spec
from quadruped_ctrl_tpu_torch.mpc import pipeline
from quadruped_ctrl_tpu_torch.ops import admm_segment as AS

CELLS = ("h16_full_solve", "h16_midband_solve", "h10_trot_solve")
SEED = 24_000_000_017
SYSTEMS = 256       # of each call, for the comparisons against the CPU


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """`tests/test_torch_package.py`'s fixture of the same name (torch's CPU
    ops on one thread), defined here: where another installed top-level
    `tests` package hides this directory from an import, the card's tests
    still run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=CELLS)
def solved(request):
    """One batch of the cell solved with the kernel and with the eager loop:
    the cell, its inputs, both forces, the launches of one solve, and the
    segment calls (operands, keywords) the kernel's solve made."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on one")
    dev = torch.device("cuda", 0)
    cell = spec.load_cell(request.param)
    cfg = spec.program_config(cell.config)
    pool = cell.generator().make_pool(dict(cell.traffic, pool=1), int(cell.config["horizon"]),
                                      SEED, dev)
    params = cell.workload["params"]

    def solve():
        return pipeline.solve_packed_batch(cfg, pipeline.MPCInputs(**pool[0]),
                                           max_stance=int(params["max_stance"]),
                                           pack=int(params["pack"]))

    fits, before = AS.fits, AS._KS.launches
    with AS.recorded_calls() as calls:
        forces = solve()
    launches = AS._KS.launches - before
    AS.fits = lambda n: False
    try:
        eager = solve()
    finally:
        AS.fits = fits
    torch.cuda.synchronize()
    return dict(cell=cell, pool=pool[0], forces=forces, eager=eager, launches=launches,
                calls=calls)


def _systems(args):
    """The first SYSTEMS systems of a segment's operands."""
    inv, grad, l, u, rho, carry = args
    take = lambda t: t[:SYSTEMS].contiguous()  # noqa: E731
    return (take(inv), take(grad), take(l), take(u), take(rho), tuple(take(c) for c in carry))


def _on_cpu(args):
    return tuple(tuple(c.cpu() for c in a) if isinstance(a, tuple) else a.cpu() for a in args)


def _per_system(got, want, n):
    """Each system's largest |difference| over x, z, y's true entries, over
    the reference's largest entry in that vector."""
    out = []
    for g, w, width in zip(got, want, (n, 5 * n // 3, 5 * n // 3)):
        g, w = g[:, :width].double().cpu(), w[:, :width].double().cpu()
        out.append((g - w).abs().amax(1) / w.abs().amax(1).clamp(min=1e-30))
    return torch.stack(out).amax(0)


def _quantiles(v):
    return [float(torch.quantile(v, q)) for q in (0.5, 0.9, 1.0)]


@pytest.mark.card
def test_every_segment_runs_the_kernel(solved):
    """rho_adapt + 1 segments, each one launch, each n within the route."""
    calls = solved["calls"]
    assert len(calls) == 2 and solved["launches"] == 2
    assert all(AS.fits(kw["n"]) for _, kw in calls)


@pytest.mark.card
def test_fp32_segment_holds_the_eager_loop(solved):
    """The first segment's operands, 60 fp32 iterations: each system within
    1e-4 of the eager loop on the card; the padding exactly the loop's."""
    args, kw = solved["calls"][0]
    args, kw = _systems(args), {**kw, "n_lo": 0, "n_hi": 60}
    got = AS.admm_segment(*args, **kw)
    want = AS.admm_segment_reference(*args, **kw)
    assert float(_per_system(got, want, kw["n"]).max()) <= 1e-4
    n, m = kw["n"], 5 * kw["n"] // 3
    for g, w, width in zip(got, want, (n, m, m)):
        assert torch.equal(g[:, width:], w[:, width:])


@pytest.mark.card
@pytest.mark.parametrize("call", [0, 1])
def test_solver_segments_stay_within_the_loops_own_spread(solved, call):
    """The solver's segment (the first: 60 bf16 iterations from zero; the
    second: 10 bf16 and 50 fp32 from the first's carry): the kernel's
    distance from the eager loop on the card at most three times the eager
    loop's on the CPU at the median, 90th percentile and largest system."""
    args, kw = solved["calls"][call]
    args = _systems(args)
    want = AS.admm_segment_reference(*args, **kw)
    kernel = _quantiles(_per_system(AS.admm_segment(*args, **kw), want, kw["n"]))
    cpu = _quantiles(_per_system(AS.admm_segment_reference(*_on_cpu(args), **kw), want,
                                 kw["n"]))
    assert all(k <= 3.0 * c + 1e-5 for k, c in zip(kernel, cpu)), (kernel, cpu)


@pytest.mark.card
def test_forces_correct_and_near_the_eager_loops(solved):
    """The kernel's forces `correct` under the cell's limits on 2048 sampled
    scenarios, as the eager loop's are; within 0.25 N of the eager loop's at
    the median scenario and 0.5 N at the 90th percentile."""
    cell, dev = solved["cell"], solved["forces"].device
    for forces in (solved["forces"], solved["eager"]):
        pairs = check.sample(SEED, 1, forces.shape[0], int(cell.workload["check"]["scenarios"]))
        inp, f = check.gather(pairs, [solved["pool"]], [forces], dev)
        numbers = check.judge(cell.config["mpc"], inp, f)
        nonfinite = int((~torch.isfinite(forces)).flatten(1).any(1).sum())
        correct, checks = check.verdict(numbers, cell.workload["check"]["limits"], nonfinite)
        assert correct, checks
    diff = (solved["forces"] - solved["eager"]).abs().flatten(1).amax(1).double()
    assert float(torch.quantile(diff, 0.5)) <= 0.25
    assert float(torch.quantile(diff, 0.9)) <= 0.5
