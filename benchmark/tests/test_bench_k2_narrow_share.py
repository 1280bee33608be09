"""`k2_narrow_share` on `Trace`s built by hand: 1.0 where every K2 launch at
the 256 tile ran the 3-CTA instance, 0.0 where none did, a share in
between, None without a trace or without a K2 launch at the 256 tile, and
its entry in `BENCHMARK.json`."""

import json
from types import SimpleNamespace

import pytest

from benchmark.harness import spec
from benchmark.harness.trace import Trace

NAME = "k2_narrow_share"
WIDE = "void qct::ns_refine_kernel<256, 4>(qct::RfArgs)"
NARROW = "void qct::ns_refine_kernel<192, 4>(qct::RfArgs)"


def stretch(kernels):
    """One call in 0-10 s: the given K2 launches, one a second from 1 s, among
    the iterate's gemv and K3 at the 256 tile (mode 3), which do not count."""
    device = [(1.0 + i, 1.5 + i, name) for i, name in enumerate(kernels)]
    device += [(0.2, 0.4, "gemv2T_kernel"), (9.5, 9.8, "void qct::ns_refine_kernel<256, 3>"
                                                       "(qct::RfArgs)")]
    return Trace(start=0.0, end=10.0, calls=1, device=sorted(device))


def read(trace):
    return spec.metric_reader(NAME).read(SimpleNamespace(trace=trace, peaks=None, stretch=[]))


@pytest.mark.parametrize("kernels,share", [([NARROW] * 5, 1.0), ([WIDE] * 5, 0.0),
                                           ([NARROW, WIDE, NARROW, NARROW], 0.75)])
def test_share_of_k2_launches_on_the_3_cta_instance(kernels, share):
    assert read(stretch(kernels)) == pytest.approx(share)


def test_silent_without_what_it_reads():
    assert read(None) is None
    assert read(stretch([])) is None
    assert read(Trace(start=0.0, end=1.0, calls=1)) is None


def test_entry_reads_the_h16_cells_from_the_device_trace():
    b = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entry = [m for m in b["per_layer"] if m["name"] == NAME]
    assert entry == [{"name": NAME, "unit": "share", "better": "higher",
                      "source": "device_trace", "layer": "factorization",
                      "moves": "solves_per_s",
                      "workloads": ["h16_full_solve", "h16_midband_solve"]}]
    assert b["per_layer"][-1] == entry[0]
    assert "`ns_refine_kernel<192, 4>`" in spec.metric_reader(NAME).__doc__
