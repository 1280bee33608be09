"""The port's twins of the repo root's `bench.py` and `bench_latency.py` on
the CPU: the bench twin's `main` at a few scenarios and one rep, with
exactly `bench.py`'s output keys (read from its source) and every lane
run; `timed`'s chain; the iterate timed apart on the kernel branch; the
per-phase FLOP and byte models at batch 4096 equal to `bench.py`'s
formulas evaluated on the JAX config; the midband
gait table as `bench.py` builds it; and the latency twin's `main` for a
few ticks, with `bench_latency.py`'s keys, writing nothing unless given
`out` (never LATENCY.json)."""

import ast
import json

import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu_torch import bench, bench_latency, default_config
from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.mpc import pipeline as TP
from quadruped_ctrl_tpu_torch.ops import admm_segment as AS
from tests.test_torch_package import REPO, _one_thread  # noqa: F401 (autouse)

LANES = ("h10_full", "h10_nopolish", "h10_form_fact", "h10_form_only", "h10_two_step_build",
         "h16_full", "h16_trot", "h16_midband")


def _dict_keys(node: ast.Dict) -> list:
    return [k.value for k in node.keys]


def _bench_keys():
    """(the keys of bench.py's JSON line, the keys of one phase entry)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    line = next(n.args[0] for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps" and isinstance(n.args[0], ast.Dict))
    phase = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                 and n.name == "phase")
    ret = next(n.value for n in ast.walk(phase) if isinstance(n, ast.Return))
    return _dict_keys(line), _dict_keys(ret)


def _latency_keys():
    tree = ast.parse((REPO / "bench_latency.py").read_text())
    report = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "report")
    nested = next(v for k, v in zip(report.keys, report.values)
                  if k.value == "host_p99_decomposition_ms")
    return _dict_keys(report), _dict_keys(nested)


def test_bench_main_has_bench_py_keys(tmp_path, capsys):
    out = tmp_path / "bench.json"
    rep = bench.main(batch=4, batch16=2, n_reps=1, n_reps16=1, device="cpu", out=str(out))
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line == rep == json.loads(out.read_text())
    keys, phase_keys = _bench_keys()
    assert list(line) == keys
    assert line["lane_errors"] is None
    for lane in LANES:
        assert f"# lane {lane}: ok" in captured.err
    for k in ("value", "h16_solves_per_s", "h16_trot_solves_per_s", "h16_midband_solves_per_s",
              "fused_build_solves_per_s", "two_step_build_solves_per_s"):
        assert line[k] > 0, k
    assert line["metric"] == "mpc_solves_per_s_per_chip"
    assert [p["name"] for p in line["phases"]] == ["formation", "factorize(NS)",
                                                   "iterate(ADMM)", "polish+fact"]
    for p in line["phases"]:
        # bench.py's keys plus the peak named; no share of a device bound
        # from a CPU run
        assert list(p) == phase_keys + ["peak"]
        assert p["attained_pct"] is None and p["peak"].startswith("not measured")
        assert p["ms"] > 0


def test_iterate_timed_apart_replays_the_segments(monkeypatch):
    """On the kernel branch (forced here; the references run on the CPU)
    `_iterate` records one solve's two segment calls and replays them in a
    chain, a warm-up chain and three timed ones; its bytes are each system's
    inverse once a segment (twice in the one that switches to fp32
    products) and its vectors."""
    monkeypatch.setattr(_device, "use_kernels",
                        lambda t, use_kernels=None: True if use_kernels is None else use_kernels)
    seen, real = [], AS.admm_segment

    def counted(*args, **kw):
        seen.append((kw["n"], kw["n_lo"], kw["n_hi"]))
        return real(*args, **kw)

    monkeypatch.setattr(AS, "admm_segment", counted)
    t, nbytes = bench._iterate(default_config(), TP.random_inputs(0, 4, 10, device="cpu"), 2)
    assert t > 0 and len(seen) == 2 + 2 * 2 * 4
    assert set(seen) == {(120, 60, 0), (120, 10, 50)}
    vectors = 3 * 128 + 7 * 256                      # 2 systems, np 128, mp 256
    assert nbytes == 4 * 2 * ((120 ** 2 + vectors) + (2 * 120 ** 2 + vectors))


def test_timed_chains_the_reps():
    """Each rep sees the previous rep's forces in v_world; one warm-up chain
    and three timed chains."""
    inputs = TP.random_inputs(0, 2, 4, device="cpu")
    seen = []

    def fn(inp):
        seen.append(inp.v_world.clone())
        return torch.ones((2, 4, 4, 3))

    t = bench.timed(fn, inputs, 3)
    assert t > 0 and len(seen) == 4 * 3
    for chain in range(4):
        vs = seen[3 * chain:3 * chain + 3]
        assert torch.equal(vs[0], inputs.v_world)
        assert torch.equal(vs[1], inputs.v_world + 1e-9)
        assert torch.equal(vs[2], vs[1] + 1e-9)


def test_phase_models_equal_bench_py():
    """bench.py's formulas (bench.py:137-176), written out here and
    evaluated on the JAX config at batch 4096, h=10."""
    cfg = jax_default_config()
    batch, h = 4096, 10
    iters = cfg.solver.iterations
    polish = cfg.solver.polish_rounds
    ms, pack = 2, 2
    n_c = 3 * ms * h
    npad = 128
    mp_ = 256
    sysN = batch // pack
    ns_admm = (cfg.solver.ns_admm_scaled_iters + cfg.solver.ns_quad_iters
               + cfg.solver.ns_hi_iters)
    ns_pol = (cfg.solver.ns_scaled_iters + cfg.solver.ns_quad_iters
              + cfg.solver.ns_hi_iters)
    flops_form = batch * 2 * (13 * h) * n_c * n_c * 2
    bytes_form = batch * (13 * h * n_c * 2 + n_c * n_c) * 4
    flops_fact = 2 * sysN * ns_admm * 2 * 2 * npad**3
    bytes_fact = 2 * sysN * 2 * npad * npad * 4
    n_lo = iters - min(cfg.solver.f32_tail_iters, iters)
    n_hi_i = iters - n_lo
    flops_iter = iters * sysN * 2 * (npad**2 + 2 * npad * mp_)
    bytes_iter = sysN * npad * npad * (2 * n_lo + 4 * n_hi_i)
    flops_pol_fact = polish * sysN * ns_pol * 2 * 2 * npad**3
    bytes_pol_fact = polish * sysN * 2 * npad * npad * 4
    flops_pol = polish * sysN * 2 * 3 * npad**2
    bytes_pol = polish * sysN * 3 * npad * npad * 4
    want = {"formation": (flops_form, bytes_form),
            "factorize(NS)": (flops_fact, bytes_fact),
            "iterate(ADMM)": (flops_iter, bytes_iter),
            "polish+fact": (flops_pol + flops_pol_fact, bytes_pol + bytes_pol_fact)}
    assert bench._phase_models(default_config(), batch, h) == want


def test_peaks_are_the_h100_data_sheet():
    assert bench.PEAK_BF16_TFLOPS == 989.0 and bench.PEAK_HBM_GBS == 3350.0
    assert bench.PEAK_F32_TFLOPS == pytest.approx(989.0 / 3)


def test_midband_table_as_bench_py_builds_it():
    h16, v_band = 16, 0.3
    o2 = int(np.floor(h16 * 1.25 * v_band))
    o3 = int(np.floor(h16 * (1.25 * v_band + 0.5)))
    dwt = int(np.floor(h16 * (-1.25 * v_band + 1.0)))
    offs = np.array([0, h16 // 2, o2, o3])
    steps = np.arange(h16)[:, None]
    tbl = (((steps - offs[None, :]) % h16) < dwt).astype(np.float32)
    np.testing.assert_array_equal(bench._midband_table(h16), tbl)


def test_latency_main_writes_only_to_out(tmp_path, monkeypatch, capsys):
    latency_json = REPO / "LATENCY.json"
    before = latency_json.stat().st_mtime_ns
    monkeypatch.chdir(tmp_path)
    rep = bench_latency.main(ticks=3, macros=1, device="cpu")
    assert list(tmp_path.iterdir()) == []
    assert latency_json.stat().st_mtime_ns == before
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rep
    keys, nested = _latency_keys()
    assert list(rep) == keys and list(rep["host_p99_decomposition_ms"]) == nested
    assert rep["backend"] == "cpu" and rep["host_roundtrip_p50_ms"] > 0
    assert rep["device_per_tick_ms"] > 0
    out = tmp_path / "lat.json"
    bench_latency.main(ticks=2, macros=1, device="cpu", out=str(out))
    assert list(json.loads(out.read_text())) == keys
    assert sorted(p.name for p in tmp_path.iterdir()) == ["lat.json"]
