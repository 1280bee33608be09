"""The device-time readers of the stage-wise cell's phases
(`factorize_device_ms`, `iterate_device_ms`) on a `Trace` built by hand,
the per-layer metrics each new cell is listed under, and the two cells
`h16_sparse_solve` and `h10_fused_solve` on the CPU at a small size: the
program passes, the TF32 control and each planted fault fail."""

import json
from types import SimpleNamespace

import pytest

from benchmark import run as bench
from benchmark.harness import control, spec
from benchmark.harness.trace import Trace

READERS = ("factorize_device_ms", "iterate_device_ms")
# the per-layer metrics whose spans or counters each new cell's path has:
# the stage-wise solve runs `qct.solve`, `qct.formation`, `qct.factorize` and
# `qct.admm.iterate` and no kernel of the port; the fused solve runs
# `qct.solve` and `qct.formation`, then K5 (no `qct.factorize` or
# `qct.admm.iterate` span)
LISTED = {
    "h16_sparse_solve": ("launches_per_call.batch", "device_idle_share.batch",
                         "solve_syncs_per_call.batch", "formation_idle_ms",
                         "iterate_idle_ms.batch", "torch_ops_device_ms",
                         "iterate_device_ms", "factorize_device_ms"),
    "h10_fused_solve": ("launches_per_call.batch", "device_idle_share.batch",
                        "solve_syncs_per_call.batch", "formation_idle_ms",
                        "torch_ops_device_ms"),
}
SMALL = {"h16_sparse_solve": {"batch": 2, "pool": 2},
         "h10_fused_solve": {"batch": 16, "pool": 2}}


def stretch():
    """Two calls in 0-10 s. The host is in `qct.factorize` 0.5-1.5 (with a
    nested range of its own name) and 5.5-6.5, in `qct.admm.iterate`
    2.0-4.0 and 7.0-8.5; the device runs each launch's activity 0.5 s
    after it: the factorizations' gemms 1-2 and 6-7.5, the iterate's gemvs
    2.5-3 and 7.5-8.5, and a copy at 9.6 launched outside both."""
    return Trace(
        start=0.0, end=10.0, calls=2,
        device=[(1.0, 2.0, "gemm"), (2.5, 3.0, "gemv"), (6.0, 7.5, "gemm"),
                (7.5, 8.5, "gemv"), (9.6, 9.7, "Memcpy DtoH (Device -> Pageable)")],
        runtime=[(0.6, 0.7, "cudaLaunchKernel", "gemm"),
                 (2.1, 2.2, "cudaLaunchKernel", "gemv"),
                 (5.6, 5.7, "cudaLaunchKernel", "gemm"),
                 (7.1, 7.2, "cudaLaunchKernel", "gemv"),
                 (9.5, 9.8, "cudaMemcpyAsync", "Memcpy DtoH (Device -> Pageable)")],
        host=[(0.4, 9.0, "qct.solve"), (0.5, 1.5, "qct.factorize"),
              (0.6, 1.0, "qct.factorize"), (2.0, 4.0, "qct.admm.iterate"),
              (5.5, 6.5, "qct.factorize"), (7.0, 8.5, "qct.admm.iterate")])


def read(name, trace):
    return spec.metric_reader(name).read(SimpleNamespace(trace=trace, peaks=None, stretch=[]))


def test_device_time_inside_each_span():
    """Factorizations 1.0 + 1.5 s, iterations 0.5 + 1.0 s, over 2 calls."""
    tr = stretch()
    assert read("factorize_device_ms", tr) == pytest.approx(1250.0)
    assert read("iterate_device_ms", tr) == pytest.approx(750.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_are_null_without_what_they_read(name):
    """No trace, no device activity (a run on the CPU), no `qct.` spans (a
    program without them), or a pairing that is not exact: None."""
    tr = stretch()
    assert read(name, None) is None
    assert read(name, Trace(tr.start, tr.end, tr.calls, host=tr.host)) is None
    no_spans = Trace(tr.start, tr.end, tr.calls, device=tr.device, runtime=tr.runtime,
                     host=[h for h in tr.host if not h[2].startswith("qct.")])
    assert read(name, no_spans) is None
    fewer = Trace(tr.start, tr.end, tr.calls, device=tr.device[1:], runtime=tr.runtime,
                  host=tr.host)
    assert read(name, fewer) is None


@pytest.mark.parametrize("name", READERS)
def test_entry_reads_the_sparse_cell_from_the_device_trace(name):
    b = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entry = [m for m in b["per_layer"] if m["name"] == name]
    assert len(entry) == 1 and entry[0]["source"] == "device_trace"
    assert "h16_sparse_solve" in entry[0]["workloads"]
    assert "`qct." in spec.metric_reader(name).__doc__


@pytest.mark.parametrize("cell", list(LISTED))
def test_each_new_cell_is_listed_where_its_path_has_the_span(cell):
    """A new cell is listed under exactly the metrics whose spans or
    counters its path has, and under no roofline (no kernel those read
    runs there)."""
    b = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in b["per_layer"] if cell in m.get("workloads", [])}
    assert listed == set(LISTED[cell])


def run_small(cell, seed, wrap=None, seconds=0.05):
    args = bench.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)])
    result, _, _, _ = bench.run(args, device="cpu", entry_wrap=wrap, traffic_over=SMALL[cell])
    return result


@pytest.mark.parametrize("cell", list(SMALL))
def test_the_program_passes(cell):
    assert run_small(cell, 2 ** 31 + 101)["correct"] is True


@pytest.mark.parametrize("cell", list(SMALL))
def test_the_tf32_control_fails(cell):
    mpc = spec.load_cell(cell).config["mpc"]
    assert run_small(cell, 2 ** 31 + 101, control.tf32_control(mpc))["correct"] is False


@pytest.mark.parametrize("cell,fault", [(c, f) for c in SMALL for f in control.FAULTS])
def test_each_fault_fails(cell, fault):
    assert run_small(cell, 2 ** 31 + 202, control.FAULTS[fault])["correct"] is False


def test_the_sparse_configuration_is_the_programs():
    """The configuration's settings reach the port unchanged, and the entry
    passes its weights, mu and budgets to `solve_sparse_batch`."""
    c = spec.load_cell("h16_sparse_solve")
    cfg = spec.program_config(c.config)
    assert list(cfg.mpc.weights) == [0.25, 0.25, 10.0, 2.0, 2.0, 20.0, 0.0, 0.0, 0.3, 0.2,
                                     0.2, 0.2]
    assert cfg.mpc.mu == 1.0 and cfg.solver.iterations == 150
    assert cfg.solver.polish_rounds == 6 and c.config["reduced"] == []
