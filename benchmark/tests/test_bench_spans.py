"""The readers of the port's `qct.*` spans (`harness/spans.py` and the
metrics built on it) on `Trace`s built by hand: the idle time inside a span,
the syncs inside and outside `qct.solve`, the launch pairing and where it
is refused, and silence without a trace, without device activity or
without the spans (a program that has none)."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spans, spec
from benchmark.harness.trace import Trace

SPAN_METRICS = ("solve_syncs_per_call.batch", "solve_syncs_per_call.robot",
                "formation_idle_ms", "iterate_idle_ms.batch", "iterate_idle_ms.robot",
                "iterate_device_ms", "iterate_launches_per_call")


def stretch():
    """Two calls in 0-10 s. The device is busy 1-2, 3-4 and 6-8 s; the host
    is in `qct.solve` 0.5-4.5 and 5.5-9 (the harness's copy at 9.5), in
    `qct.formation` 0.5-1.5 and 5.5-6.5, in `qct.admm.iterate` 2.5-4.2
    (with a nested range of its own name) and 7-8.5."""
    return Trace(
        start=0.0, end=10.0, calls=2,
        device=[(1.0, 2.0, "qct::form_packed_kernel"), (3.0, 4.0, "gemv"),
                (6.0, 7.0, "qct::form_packed_kernel"), (7.0, 8.0, "gemv"),
                (9.6, 9.7, "Memcpy DtoH (Device -> Pageable)")],
        runtime=[(0.6, 0.7, "cudaLaunchKernel", "qct::form_packed_kernel"),
                 (0.8, 0.9, "cudaStreamSynchronize", ""),
                 (2.6, 2.7, "cudaLaunchKernel", "gemv"),
                 (4.3, 4.4, "cudaEventRecord", ""),
                 (5.6, 5.7, "cudaLaunchKernel", "qct::form_packed_kernel"),
                 (7.1, 7.2, "cudaLaunchKernel", "gemv"),
                 (9.5, 9.8, "cudaMemcpyAsync", "Memcpy DtoH (Device -> Pageable)"),
                 (9.8, 9.9, "cudaStreamSynchronize", "")],
        host=[(0.5, 4.5, "qct.solve"), (0.5, 1.5, "qct.formation"),
              (2.5, 4.2, "qct.admm.iterate"), (3.0, 3.5, "qct.admm.iterate"),
              (5.5, 9.0, "qct.solve"), (5.5, 6.5, "qct.formation"),
              (7.0, 8.5, "qct.admm.iterate"), (9.5, 9.9, "aten::to")])


def ctx(trace):
    return SimpleNamespace(trace=trace, peaks=None, stretch=[])


def read(name, trace):
    return spec.metric_reader(name).read(ctx(trace))


def test_intervals_merge_and_the_inside_test():
    tr = stretch()
    assert spans.intervals(tr, "qct.admm.iterate") == [(2.5, 4.2), (7.0, 8.5)]
    assert spans.intervals(tr, "qct.nothing") == []
    ivs = spans.intervals(tr, "qct.solve")
    assert spans.inside(ivs, 0.5) and spans.inside(ivs, 4.5) and spans.inside(ivs, 6.0)
    assert not spans.inside(ivs, 0.4) and not spans.inside(ivs, 5.0)
    assert not spans.inside(ivs, 9.5) and not spans.inside([], 1.0)


def test_idle_inside_a_span():
    tr = stretch()
    assert spans.idle_intervals(tr) == [(0.0, 1.0), (2.0, 3.0), (4.0, 6.0), (8.0, 9.6),
                                        (9.7, 10.0)]
    # formation: 0.5-1.0 and 5.5-6.0 idle; iterate: 2.5-3.0, 4.0-4.2, 8.0-8.5
    assert spans.idle_in(tr, "qct.formation") == pytest.approx(1.0)
    assert spans.idle_in(tr, "qct.admm.iterate") == pytest.approx(1.2)
    assert read("formation_idle_ms", tr) == pytest.approx(500.0)
    assert read("iterate_idle_ms.batch", tr) == pytest.approx(600.0)
    assert read("iterate_idle_ms.robot", tr) == pytest.approx(600.0)
    assert spans.overlap_s([(0, 2), (3, 5)], [(1, 4)]) == pytest.approx(2.0)


def test_syncs_inside_and_outside_the_solve():
    """The sync at 0.8 s is the solve's; the copy to the host and the
    synchronize after it (9.5-9.9 s) are the harness's, outside
    `qct.solve`; the whole stretch's reader counts all three."""
    tr = stretch()
    assert read("solve_syncs_per_call.batch", tr) == pytest.approx(0.5)
    assert read("solve_syncs_per_call.robot", tr) == pytest.approx(0.5)
    assert read("syncs_per_call.robot", tr) == pytest.approx(1.5)


def test_launch_pairing():
    tr = stretch()
    pairs = spans.launches(tr)
    assert [(t, n) for t, _, _, n in pairs] == [
        (0.6, "qct::form_packed_kernel"), (2.6, "gemv"), (5.6, "qct::form_packed_kernel"),
        (7.1, "gemv"), (9.5, "Memcpy DtoH (Device -> Pageable)")]
    assert [p[0] for p in spans.launched_in(tr, "qct.admm.iterate")] == [2.6, 7.1]
    assert read("iterate_device_ms", tr) == pytest.approx(1000.0)
    assert read("iterate_launches_per_call", tr) == pytest.approx(1.0)


def test_pairing_is_refused_where_it_is_not_exact():
    tr = stretch()
    fewer = Trace(tr.start, tr.end, tr.calls, device=tr.device[1:], runtime=tr.runtime,
                  host=tr.host)
    assert spans.launches(fewer) is None and read("iterate_device_ms", fewer) is None
    renamed = Trace(tr.start, tr.end, tr.calls, device=tr.device, host=tr.host,
                    runtime=[r if r[3] != "gemv" else r[:3] + ("gemm",) for r in tr.runtime])
    assert spans.launches(renamed) is None and read("iterate_device_ms", renamed) is None
    assert read("iterate_launches_per_call", renamed) == pytest.approx(1.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_readers_are_silent_without_what_they_read(name):
    tr = stretch()
    assert read(name, None) is None
    no_spans = Trace(tr.start, tr.end, tr.calls, device=tr.device, runtime=tr.runtime,
                     host=[h for h in tr.host if not h[2].startswith("qct.")])
    assert read(name, no_spans) is None
    on_cpu = Trace(tr.start, tr.end, tr.calls, host=tr.host)
    assert read(name, on_cpu) is None
    assert read(name, tr) is not None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_each_entry_names_the_span_it_reads(name):
    """Each span metric is a `per_layer` entry read from the device trace,
    and its file's docstring names a `qct.` span."""
    import json

    b = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entry = [m for m in b["per_layer"] if m["name"] == name]
    assert len(entry) == 1 and entry[0]["source"] == "device_trace"
    assert "`qct." in spec.metric_reader(name).__doc__
