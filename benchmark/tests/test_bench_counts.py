"""Exact work counts from shapes and gait tables, the traffic generator's
seeding, the shape of the last line, the command without a card, and
BENCHMARK.json against the benchmark's contract."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness import spec

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def pool(cell, seed, batch=8, n=2, device="cpu"):
    c = spec.load_cell(cell)
    traffic = dict(c.traffic, batch=batch, pool=n)
    return c.generator().make_pool(traffic, int(c.config["horizon"]), seed, device)


@pytest.mark.parametrize("cell,n_need", [("h16_full_solve", 96), ("h10_trot_solve", 60),
                                         ("h10_robot_solve", 60), ("h16_midband_solve", 120)])
def test_stance_variables(cell, n_need):
    fact = spec.metric_reader("factorization_roofline")
    b = pool(cell, 1)[0]
    assert fact.stance_variables(b["gait_table"]) == [n_need] * 8


def test_factorization_work():
    fact = spec.metric_reader("factorization_roofline")
    solver = spec.load_cell("h16_full_solve").config["solver"]
    assert fact.factorizations(solver) == 5
    assert fact.work(96, 5) == (5 * 2 * 96 ** 3, 5 * 2 * 96 * 96 * 4)
    peaks = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    batches = pool("h16_full_solve", 1, batch=2048, n=1)
    # bytes bound: 5 x 2048 x 2 x 96^2 x 4 B over 3.35 TB/s
    assert fact.bound_seconds(batches, solver, peaks) == pytest.approx(
        5 * 2048 * 2 * 96 * 96 * 4 / 3.35e12, rel=1e-12)


def test_formation_work():
    form = spec.metric_reader("formation_roofline")
    assert form.work(60, 10) == (130 * 60 * 61, 4 * (25 + 130 + 40 + 3600 + 60))
    assert form.work(96, 16) == (208 * 96 * 97, 4 * (25 + 208 + 64 + 96 * 96 + 96))
    peaks = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    batches = pool("h16_midband_solve", 1, batch=4, n=2)
    assert form.bound_seconds(batches, peaks) == pytest.approx(
        8 * 4 * (25 + 208 + 64 + 120 * 120 + 120) / 3.35e12, rel=1e-12)


def test_rooflines_are_silent_without_a_trace():
    from types import SimpleNamespace

    ctx = SimpleNamespace(trace=None, peaks=None, stretch=[])
    for name in ("factorization_roofline", "formation_roofline", "torch_ops_device_ms",
                 "launches_per_call.batch", "device_idle_share.batch",
                 "syncs_per_call.robot"):
        assert spec.metric_reader(name).read(ctx) is None


def test_pool_follows_the_seed():
    seed = 2 ** 31 + 12345
    a, b = pool("h10_trot_solve", seed), pool("h10_trot_solve", seed)
    c = pool("h10_trot_solve", seed + 1)
    for k in a[0]:
        assert torch.equal(a[1][k], b[1][k])
    assert not torch.equal(a[0]["rpy"], c[0]["rpy"])
    assert not torch.equal(a[0]["rpy"], a[1]["rpy"])
    r = a[0]
    assert (r["position"][:, 2] >= 0.25).all() and (r["position"][:, 2] <= 0.3).all()
    assert torch.equal(r["traj"][:, :, 9], r["v_world"][:, None, 0].expand(8, 10))
    assert (r["traj"][:, :, 5] == 0.25).all() and (r["x_drag"] == 0).all()


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_shape_on_a_cpu_rehearsal(trace):
    from benchmark import run as bench

    args = bench.parse(["--workload", "h16_midband_solve", "--seed", "2147483659",
                        "--seconds", "0.3", "--trace", str(trace)])
    result, notes, lines, numbers = bench.run(args, device="cpu",
                                              traffic_over={"batch": 2, "pool": 2})
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks" and result["correct"] is True
    limits = spec.load_cell("h16_midband_solve").workload["check"]["limits"]
    assert set(result["checks"]) == set(limits) | {"nonfinite"} and set(limits) <= set(numbers)
    assert all(line.startswith("check ") and " limit " in line for line in lines)
    json.dumps(result)
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"solves_per_s", "setup_s"}


def test_the_command_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "h10_trot_solve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        names.add(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (BENCH / "workloads" / f"{w['name']}.json").exists()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()
            assert set(m.get("workloads", cells)) <= cells
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
            else:
                assert m["moves"] in e2e and len(m["layer"]) <= 200
                moved = e2e[m["moves"]].get("workloads", cells)
                assert set(m["workloads"]) <= set(moved)
    for cell in cells:
        reports = [m for m in b["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reports) >= 2 and any(m["name"] == "setup_s" for m in reports)
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])
