"""`iterate_resident_share` on `Trace`s built by hand: 1.0 where every
`qct.admm.iterate` span launched the segment kernel, 0.0 where none did (the
iterate as plain ops), a share in between, None without a trace or without
such a span, and its entry in `BENCHMARK.json`."""

import json
from types import SimpleNamespace

import pytest

from benchmark.harness import spec
from benchmark.harness.trace import Trace

NAME = "iterate_resident_share"
KERNEL = "qct::admm_segment_kernel(qct::AsArgs)"


def stretch(resident):
    """One call in 0-10 s: a `qct.admm.iterate` span a second from 1 s, each
    launching the segment kernel (True) or a gemv and an elementwise op
    (False), and a K2 launch outside every span, which does not count."""
    host, runtime, device = [], [], []
    for i, res in enumerate(resident):
        t = 1.0 + i
        host.append((t, t + 0.5, "qct.admm.iterate"))
        names = [KERNEL] if res else ["gemv2T_kernel", "elementwise_kernel"]
        for j, name in enumerate(names):
            runtime.append((t + 0.1 + 0.1 * j, t + 0.15 + 0.1 * j, "cudaLaunchKernel", name))
            device.append((t + 0.2 + 0.1 * j, t + 0.25 + 0.1 * j, name))
    runtime.append((0.1, 0.15, "cudaLaunchKernelExC", "void qct::ns_refine_kernel<192, 4>"))
    device.append((0.2, 0.4, "void qct::ns_refine_kernel<192, 4>"))
    return Trace(start=0.0, end=10.0, calls=1, device=sorted(device), runtime=sorted(runtime),
                 host=sorted(host))


def read(trace):
    return spec.metric_reader(NAME).read(SimpleNamespace(trace=trace, peaks=None, stretch=[]))


@pytest.mark.parametrize("resident,share", [([True] * 2, 1.0), ([False] * 2, 0.0),
                                            ([True, False, True, True], 0.75)])
def test_share_of_iterate_spans_on_the_segment_kernel(resident, share):
    assert read(stretch(resident)) == pytest.approx(share)


def test_silent_without_what_it_reads():
    assert read(None) is None
    assert read(stretch([])) is None
    assert read(Trace(start=0.0, end=1.0, calls=1)) is None


def test_entry_reads_the_batched_cells_from_the_spans():
    b = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entry = [m for m in b["per_layer"] if m["name"] == NAME]
    assert entry == [{"name": NAME, "unit": "share", "better": "higher",
                      "source": "device_trace", "layer": "ADMM iterate",
                      "moves": "solves_per_s",
                      "workloads": ["h16_full_solve", "h10_trot_solve", "h16_midband_solve"]}]
    assert "`qct::admm_segment_kernel`" in spec.metric_reader(NAME).__doc__
