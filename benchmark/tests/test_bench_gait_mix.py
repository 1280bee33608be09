"""The mixed-gait cell `h14_gait_mix_solve`: its generator `gait_mix` (seeded,
1,024 scenarios of each of the 9 mode-0 gaits a batch, tables rolled as
Gait.cpp:142-166, the gaits' stance variables), its two readers
`route_idle_ms` and `route_var_ratio` on `Trace`s built by hand, its
entries in `BENCHMARK.json`, and the cell on the CPU at a small size: the
program passes, the TF32 control and each planted fault fail."""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import run as bench
from benchmark.harness import control, spec
from benchmark.harness.trace import Trace

CELL = "h14_gait_mix_solve"
READERS = ("route_idle_ms", "route_var_ratio")
H = 14


def traffic(**over):
    return dict(spec.load_cell(CELL).traffic, **over)


def gen():
    return spec.load_cell(CELL).generator()


def gait_cpp_table(offsets, durations, iteration: int, n: int = H) -> list:
    """OffsetDurationGait::getMpcTable (Gait.cpp:142-166), line by line:
    for i < nIterations: iter = (i + iteration + 1) % nIterations, progress
    = iter - offsets, + nIterations where negative, stance where progress <
    durations."""
    table = []
    for i in range(n):
        it = (i + iteration + 1) % n
        row = []
        for j in range(4):
            progress = it - offsets[j]
            if progress < 0:
                progress += n
            row.append(1.0 if progress < durations[j] else 0.0)
        table.append(row)
    return table


def test_the_pool_is_seeded():
    t = traffic(pool=2)
    a = gen().make_pool(t, H, 2 ** 31 + 5, "cpu")
    b = gen().make_pool(t, H, 2 ** 31 + 5, "cpu")
    c = gen().make_pool(t, H, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not torch.equal(a[0]["gait_table"], c[0]["gait_table"])
    assert not torch.equal(a[0]["rpy"], c[0]["rpy"])


def test_each_batch_holds_1024_of_each_gait_shuffled():
    t = traffic(pool=3)
    index, segment = gen().assign(t, H, 2 ** 31 + 11, "cpu")
    assert index.shape == (3, 9216) and len(t["gaits"]) == 9
    for k in range(3):
        assert torch.bincount(index[k], minlength=9).tolist() == [1024] * 9
        assert not torch.equal(index[k], torch.sort(index[k]).values)
    assert int(segment.min()) == 0 and int(segment.max()) == H - 1
    assert not torch.equal(index[0], index[1])


def test_rolled_tables_are_gait_cpps():
    """`roll` against Gait.cpp's loop for every gait and segment, and each
    pool table against its gait and segment."""
    gaits = list(traffic()["gaits"].values())
    for g in gaits:
        for seg in range(H):
            got = gen().roll(torch.tensor([g["offsets"]]), torch.tensor([g["durations"]]),
                             torch.tensor([seg]), H)[0]
            assert got.tolist() == gait_cpp_table(g["offsets"], g["durations"], seg), (g, seg)
    t = traffic(pool=1)
    pool = gen().make_pool(t, H, 2 ** 31 + 17, "cpu")
    index, segment = gen().assign(t, H, 2 ** 31 + 17, "cpu")
    for s in range(0, 9216, 97):
        g = gaits[int(index[0, s])]
        want = gait_cpp_table(g["offsets"], g["durations"], int(segment[0, s]))
        assert pool[0]["gait_table"][s].tolist() == want


def test_the_gaits_stance_variables():
    """Each gait's stance variables at h = 14, 3 x its durations' sum: 72
    bounding, pronking, trot-running; 84 galloping, pacing, trotting; 120
    walking, walking2; 168 standing."""
    want = {"bounding": 72, "pronking": 72, "trot_running": 72, "galloping": 84,
            "pacing": 84, "trotting": 84, "walking": 120, "walking2": 120, "standing": 168}
    for name, g in traffic()["gaits"].items():
        for seg in range(H):
            assert 3 * sum(map(sum, gait_cpp_table(g["offsets"], g["durations"], seg))) \
                == want[name], (name, seg)


def stretch(buckets):
    """One call in 0-10 s: `qct.route` 1-2 s (the device idle 1.5-2) and
    8-8.5 s (idle throughout), a bucket span a second from 3 s, each
    launching a kernel that runs 0.2-0.8 s into it, with `buckets` its
    (n, b)."""
    host = [(0.5, 9.0, "qct.solve"), (1.0, 2.0, "qct.route"), (8.0, 8.5, "qct.route")]
    device = [(0.0, 1.5, "k")]
    runtime = [(0.0, 0.1, "cudaLaunchKernel", "k")]
    for i, (n, b) in enumerate(buckets):
        t = 3.0 + i
        host.append((t, t + 0.9, f"qct.route.bucket n={n} b={b}"))
        runtime.append((t + 0.1, t + 0.15, "cudaLaunchKernel", "k"))
        device.append((t + 0.2, t + 0.8, "k"))
    return Trace(start=0.0, end=10.0, calls=1, device=sorted(device), runtime=sorted(runtime),
                 host=sorted(host))


def tables(*ns):
    """A batch of tables with 3 x stance pairs = each of ns."""
    out = torch.zeros((len(ns), H, 4))
    for s, n in enumerate(ns):
        out[s].view(-1)[:n // 3] = 1.0
    return {"gait_table": out}


def read(name, trace, batches=()):
    return spec.metric_reader(name).read(SimpleNamespace(trace=trace, peaks=None,
                                                         stretch=list(batches)))


def test_route_idle_inside_the_route_spans():
    """0.5 s in the first span and 0.5 s in the second, over one call."""
    assert read("route_idle_ms", stretch([(72, 2)])) == pytest.approx(1000.0)


@pytest.mark.parametrize("buckets,ns,ratio", [
    ([(72, 2), (84, 1), (168, 1)], (72, 72, 84, 168), 1.0),
    ([(168, 4)], (72, 72, 84, 168), 168 * 4 / 396),
    ([(24, 1), (84, 1)], (15, 84), 108 / 99)])
def test_route_var_ratio_sums_the_buckets_over_the_tables(buckets, ns, ratio):
    """sum n x b of the buckets over 3 x the stance pairs of the stretch's
    tables: 1.0 routed, 1.70 with every scenario at 168, above 1 where a
    width rounds up (15 variables in a 24-variable group)."""
    assert read("route_var_ratio", stretch(buckets), [tables(*ns)]) == pytest.approx(ratio)


@pytest.mark.parametrize("name", READERS)
def test_readers_are_null_without_what_they_read(name):
    """No trace, no device activity (a run on the CPU), or a program without
    the router's spans: None."""
    tr = stretch([(72, 2)])
    batches = [tables(72, 72)]
    assert read(name, None, batches) is None
    no_spans = Trace(tr.start, tr.end, tr.calls, device=tr.device, runtime=tr.runtime,
                     host=[h for h in tr.host if not h[2].startswith("qct.route")])
    assert read(name, no_spans, batches) is None
    if name == "route_idle_ms":
        assert read(name, Trace(tr.start, tr.end, tr.calls, host=tr.host), batches) is None


def test_entries_and_the_cells_metrics():
    b = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in b["per_layer"] if m["name"] in READERS}
    assert entries["route_idle_ms"] == {
        "name": "route_idle_ms", "unit": "ms/call", "better": "lower", "source": "device_trace",
        "layer": "routing (host)", "moves": "solves_per_s", "workloads": [CELL]}
    assert entries["route_var_ratio"] == {
        "name": "route_var_ratio", "unit": "ratio", "better": "lower", "source": "program_span",
        "layer": "routing", "moves": "solves_per_s", "workloads": [CELL]}
    listed = {m["name"] for m in b["end_to_end"] + b["per_layer"]
              if CELL in m.get("workloads", [])}
    assert listed == {"solves_per_s", "factorization_roofline", "formation_roofline",
                      "torch_ops_device_ms", "launches_per_call.batch",
                      "device_idle_share.batch", "solve_syncs_per_call.batch",
                      "formation_idle_ms", "iterate_idle_ms.batch", "iterate_device_ms",
                      "k2_narrow_share", "iterate_resident_share", "factorize_device_ms",
                      *READERS}
    for name in READERS:
        assert "`qct.route" in spec.metric_reader(name).__doc__
    c = spec.load_cell(CELL)
    assert c.config["reduced"] == [] and c.config["horizon"] == 14
    aio = json.loads((spec.ROOT / "benchmark/configs/cheetah_h16_aio.json").read_text())
    assert c.config["mpc"] == aio["mpc"] and c.config["solver"] == aio["solver"]


SMALL = {"batch": 2304, "per_gait": 256, "pool": 1}


def run_small(seed, wrap=None, over=SMALL):
    args = bench.parse(["--workload", CELL, "--seed", str(seed), "--seconds", "0.05"])
    result, _, _, _ = bench.run(args, device="cpu", entry_wrap=wrap, traffic_over=over)
    return result


def test_the_program_passes():
    """2,304 scenarios (256 of each gait), the check's full sample of 2,048."""
    result = run_small(2 ** 31 + 101)
    assert result["correct"] is True, result["checks"]


def test_the_tf32_control_fails():
    mpc = spec.load_cell(CELL).config["mpc"]
    small = {"batch": 72, "per_gait": 8, "pool": 1}
    assert run_small(2 ** 31 + 101, control.tf32_control(mpc), small)["correct"] is False


@pytest.mark.parametrize("fault", list(control.FAULTS))
def test_each_fault_fails(fault):
    small = {"batch": 72, "per_gait": 8, "pool": 1}
    assert run_small(2 ** 31 + 202, control.FAULTS[fault], small)["correct"] is False
