"""The port's `utils/` and `cli.py` on the CPU: tests/test_utils.py's and
tests/test_sweep_checkpoint.py's cases on the port (YAML overrides, the
metrics logger, the latency recorder, `cli sim --profile` writing a trace,
`cli sweep` resuming at batch 2, a fingerprint mismatch refused), the
checkpoint round trip and resume, `tracking_metrics` against JAX, and
`cli sweep`'s checkpoint payload at batch 2 (a dict of the `states` and
`sims` trees and two counters) written by either package loading into the
other's tree leaf for leaf (every leaf given distinct values, so a leaf in
the wrong place shows); and the four measurement subcommands at small sizes
on the CPU: `bench` (with `--profile` writing a trace and `--out` the JSON
line), `latency`, `kernels-smoke` (exit 1 on a failed case) and `scaling`
(with the two-process harness)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.sim import batch_rollout as j_br
from quadruped_ctrl_tpu.utils import checkpoint as j_ckpt
from quadruped_ctrl_tpu.utils.metrics import tracking_metrics as j_tracking
from quadruped_ctrl_tpu_torch import cli, default_config
from quadruped_ctrl_tpu_torch.control import controller as ctrl
from quadruped_ctrl_tpu_torch.core.types import Command, tree_flatten, tree_unflatten
from quadruped_ctrl_tpu_torch.sim import batch_rollout as t_br
from quadruped_ctrl_tpu_torch.sim import engine
from quadruped_ctrl_tpu_torch.sim import rollout as R
from quadruped_ctrl_tpu_torch.sim.terrain import Terrain
from quadruped_ctrl_tpu_torch.utils import checkpoint
from quadruped_ctrl_tpu_torch.utils.metrics import MetricsLogger, tracking_metrics
from quadruped_ctrl_tpu_torch.utils.timer import LatencyRecorder, Timer
from tests.test_torch_package import _one_thread  # noqa: F401

CFG, JCFG = default_config(), jax_default_config()


def test_yaml_config_overrides(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text("mpc:\n  horizon: 10\n  h_max: 10\ncontrol:\n  body_height: 0.27\n")
    cfg = cli.load_config(str(p))
    assert type(cfg).__module__ == "quadruped_ctrl_tpu_torch.config"
    assert cfg.mpc.horizon == 10 and cfg.mpc.h_max == 10
    assert cfg.control.body_height == 0.27
    assert cli.load_config(None, {"sim.mu": 0.5}).sim.mu == 0.5


def test_metrics_logger(tmp_path):
    path = tmp_path / "m.jsonl"
    MetricsLogger(str(path)).log({"a": 1.5})
    rec = json.loads(path.read_text().strip())
    assert rec["a"] == 1.5 and "t" in rec


def test_latency_recorder():
    rec = LatencyRecorder()
    for v in [1.0, 2.0, 3.0, 10.0]:
        rec.record(v)
    s = rec.summary()
    assert s["count"] == 4
    assert s["p50_ms"] in (2.0, 3.0)
    assert s["max_ms"] == 10.0
    assert Timer().get_ns() >= 0


def test_tracking_metrics_matches_jax():
    rng = np.random.default_rng(2)
    traj = dict(v=rng.uniform(-1, 1, (40, 3)), p=rng.uniform(0.05, 0.3, (40, 3)),
                rpy=rng.uniform(-0.2, 0.2, (40, 3)), safety=rng.uniform(size=40) > 0.3)
    traj = {k: np.asarray(v, np.float32 if v.dtype != bool else bool) for k, v in traj.items()}
    want = j_tracking({k: jnp.asarray(v) for k, v in traj.items()}, (0.4, 0.1), 0.25)
    got = tracking_metrics({k: torch.as_tensor(v) for k, v in traj.items()}, (0.4, 0.1), 0.25)
    assert got == pytest.approx(want, abs=1e-6)


def test_cli_sim_profile_trace(tmp_path, capsys):
    """`cli sim --profile DIR` captures a torch.profiler trace and prints the
    JAX CLI's JSON line."""
    prof = tmp_path / "trace"
    rc = cli.main(["sim", "--gait", "trot", "--terrain", "plane", "--vx", "0.3",
                   "--ticks", "20", "--profile", str(prof), "--device", "cpu"])
    assert rc == 0
    assert list(prof.glob("*.pt.trace.json")), "no profiler trace written"
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"vx_mean", "vx_err", "height_mean", "safety_ok", "fell", "ticks", "wall_seconds",
            "realtime_factor", "gait", "terrain"} <= set(line)
    assert line["ticks"] == 20 and line["safety_ok"] and not line["fell"]


def test_cli_sweep_resumes_from_checkpoint(tmp_path, capsys):
    ckpt = str(tmp_path / "cli_sweep.npz")
    args = ["sweep", "--batch", "2", "--macros", "2", "--checkpoint", ckpt,
            "--checkpoint-every", "1", "--seed", "1", "--device", "cpu"]
    assert cli.main(args) == 0
    first = capsys.readouterr().out
    # same invocation again: resumes at the recorded macro count and
    # re-emits metrics without redoing the stand phase
    assert cli.main(args) == 0
    second = capsys.readouterr().out
    assert "resumed" in second and "macro 2/2" in second
    assert "robot_ticks_per_s" in first
    a, b = (json.loads(out.strip().splitlines()[-1]) for out in (first, second))
    assert a["survival_rate"] == b["survival_rate"] == 1.0
    assert a["safety_rate"] == b["safety_rate"] == 1.0


def test_checkpoint_fingerprint_mismatch_refused(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.float32)}
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, tree, fingerprint={"seed": 0, "terrains": "plane"})
    out = checkpoint.load(path, tree, fingerprint={"seed": 0, "terrains": "plane"})
    assert int(out["a"][3]) == 3
    with pytest.raises(ValueError, match="different run"):
        checkpoint.load(path, tree, fingerprint={"seed": 1, "terrains": "plane"})
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load(path, {"a": torch.zeros(4), "b": torch.zeros(2)},
                        fingerprint={"seed": 0, "terrains": "plane"})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(path, {"a": torch.zeros(5)})
    legacy = str(tmp_path / "legacy.npz")
    checkpoint.save(legacy, tree)
    with pytest.warns(UserWarning, match="no stored fingerprint"):
        checkpoint.load(legacy, tree, fingerprint={"seed": 0})


def test_checkpoint_round_trip_and_resume(tmp_path):
    """A session resumed from a checkpoint continues as the uninterrupted one
    (tests/test_utils.py's round trip and resume, on a 100-tick session)."""
    cmds = R.make_command_sequence(CFG, 100, Command.create(0.3, 0.0, 0.0, device="cpu"))
    state, sim, _ = R.rollout(CFG, Terrain.plane(device="cpu"), cmds, device="cpu")
    path = str(tmp_path / "mid.npz")
    checkpoint.save(path, (state, sim))
    state_r, sim_r = checkpoint.load(path, (state, sim))
    for a, b in zip(tree_flatten((state, sim))[0], tree_flatten((state_r, sim_r))[0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    sens = engine.sensors_from_sim(CFG, sim)
    cmd = Command.create(0.3, 0.0, 0.0, device="cpu")
    _, o1 = ctrl.controller_step(CFG, state, sens, cmd)
    _, o2 = ctrl.controller_step(CFG, state_r, sens, cmd)
    np.testing.assert_allclose(o1.tau.numpy(), o2.tau.numpy(), atol=1e-6)


def _distinct(leaves, like):
    """Leaves of the same shapes and dtypes with values that differ from
    leaf to leaf, each made by `like` from a numpy array."""
    out = []
    for i, x in enumerate(leaves):
        x = np.asarray(x)
        if x.dtype == bool:
            v = (np.arange(x.size) + i) % 3 == 0
        else:
            v = np.arange(x.size) * 0.5 + 1000.0 * i
        out.append(like(v.reshape(x.shape).astype(x.dtype)))
    return out


def _named(obj):
    """A tree as nested dicts keyed by field name, leaves as numpy."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _named(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _named(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [_named(x) for x in obj]
    return obj.numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj)


def _assert_same(got, want, path="tree"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.fixture(scope="module")
def batch2_trees():
    """`cli sweep`'s checkpoint payload at batch 2 in each package: a dict
    whose keys are written in another order than the sorted one."""
    jterr = j_br.batch_terrains(2, jax.random.PRNGKey(0), kinds=("plane",))
    tterr = t_br.batch_terrains(2, torch.Generator(), kinds=("plane",), device="cpu")
    (js, jm), (ts, tm) = (j_br.batch_init(JCFG, jterr, 2),
                          t_br.batch_init(CFG, tterr, 2, device="cpu"))
    return ({"states": js, "sims": jm, "done": jnp.zeros((), jnp.int32),
             "wall": jnp.zeros((), jnp.float32)},
            {"states": ts, "sims": tm, "done": torch.zeros((), dtype=torch.int32),
             "wall": torch.zeros(())})


def test_jax_checkpoint_loads_into_the_port(tmp_path, batch2_trees):
    jtree, ttree = batch2_trees
    leaves, treedef = jax.tree.flatten(jtree)
    jtree = jax.tree.unflatten(treedef, _distinct(leaves, jnp.asarray))
    path = str(tmp_path / "jax.npz")
    j_ckpt.save(path, jtree, fingerprint={"seed": 3})
    got = checkpoint.load(path, ttree, fingerprint={"seed": 3})
    _assert_same(_named(got), _named(jtree))


def test_port_checkpoint_loads_into_jax(tmp_path, batch2_trees):
    jtree, ttree = batch2_trees
    leaves, spec = tree_flatten(ttree)
    ttree = tree_unflatten(spec, _distinct([x.numpy() for x in leaves], torch.as_tensor))
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, ttree, fingerprint={"seed": 3})
    got = j_ckpt.load(path, jtree, fingerprint={"seed": 3})
    _assert_same(_named(got), _named(ttree))


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_cli_bench_profile_and_out(tmp_path, capsys):
    prof, out = tmp_path / "trace", tmp_path / "bench.json"
    rc = cli.main(["bench", "--batch", "4", "--batch16", "2", "--reps", "1", "--reps16", "1",
                   "--profile", str(prof), "--out", str(out), "--device", "cpu"])
    assert rc == 0
    assert list(prof.glob("*.pt.trace.json")), "no profiler trace written"
    line = _last_json(capsys.readouterr().out)
    assert line == json.loads(out.read_text())
    assert line["lane_errors"] is None and line["value"] > 0
    assert "batch=4" in line["unit"] and len(line["phases"]) == 4


def test_cli_latency(tmp_path, capsys):
    out = tmp_path / "lat.json"
    assert cli.main(["latency", "--ticks", "3", "--macros", "1", "--out", str(out),
                     "--device", "cpu"]) == 0
    line = _last_json(capsys.readouterr().out)
    assert line == json.loads(out.read_text())
    assert line["metric"] == "control_cycle_latency" and line["backend"] == "cpu"


def test_cli_kernels_smoke(tmp_path, capsys, monkeypatch):
    out = tmp_path / "lane.txt"
    assert cli.main(["kernels-smoke", "--out", str(out), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "16 cases, 0 failed" in printed and "device=cpu" in printed
    assert out.read_text().strip().endswith("16 cases, 0 failed")
    from quadruped_ctrl_tpu_torch.utils import kernels_smoke

    monkeypatch.setattr(kernels_smoke, "run_smoke",
                        lambda full=None, device=None: (["case  FAIL  RuntimeError"], 1))
    assert cli.main(["kernels-smoke", "--device", "cpu"]) == 1
    assert "1 cases, 1 failed" in capsys.readouterr().out


def test_cli_scaling_with_multiprocess(tmp_path, capsys):
    out = tmp_path / "scaling.json"
    assert cli.main(["scaling", "--per-device-batch", "2", "--reps", "1", "--multiprocess",
                     "2", "--out", str(out), "--device", "cpu"]) == 0
    rep = _last_json(capsys.readouterr().out)
    assert rep == json.loads(out.read_text())
    assert [r["devices"] for r in rep["rows"]] == [1]
    assert rep["rows"][0]["weak_efficiency"] == 1.0
    mp = rep["multiprocess"]
    assert mp["processes"] == 2 and mp["global_devices"] == 4 and mp["backend"] == "cpu"
    assert mp["solves_per_s_single_process"] > 0 and mp["solves_per_s_multi_process"] > 0
    assert mp["cross_process_efficiency"] > 0
