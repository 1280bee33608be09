"""The PyTorch port as a package: it and chip_smoke.py import no JAX and
nothing of the JAX package, its config equals the JAX package's field by
field, its entry points default to the card, the kernel build imports without
nvcc, and the CUDA route is never taken for a CPU tensor."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run a module's torch CPU ops on one thread: the solve is many small
    ops, and with a thread pool in each of the test workers that share the
    machine's cores one solve measured 60 s instead of 0.2 s. The other port
    test modules import this fixture by name."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)


def test_package_and_chip_smoke_import_no_jax():
    code = (
        "import sys\n"
        "import quadruped_ctrl_tpu_torch\n"
        "from quadruped_ctrl_tpu_torch import config, device\n"
        "from quadruped_ctrl_tpu_torch.mpc import formation, pipeline\n"
        "from quadruped_ctrl_tpu_torch.ops import _build, _launch, formation_pack, fused_admm\n"
        "from quadruped_ctrl_tpu_torch.ops import ns_inverse\n"
        "from quadruped_ctrl_tpu_torch.solver import admm, ipm, problem_generator\n"
        "from quadruped_ctrl_tpu_torch.core import interpolation, precision, rotations, types\n"
        "from quadruped_ctrl_tpu_torch.models import leg_kinematics\n"
        "from quadruped_ctrl_tpu_torch.gait import gait\n"
        "from quadruped_ctrl_tpu_torch.mpc import reference\n"
        "from quadruped_ctrl_tpu_torch.control import (controller, desired_state,\n"
        "                                              leg_controller, safety, swing)\n"
        "from quadruped_ctrl_tpu_torch.estimation import cheater, linear_kf, orientation\n"
        "from quadruped_ctrl_tpu_torch.sim import (articulated, batch_rollout, camera, engine,\n"
        "                                          rollout, terrain)\n"
        "from quadruped_ctrl_tpu_torch.models import actuator, floating_base, spatial\n"
        "from quadruped_ctrl_tpu_torch.mpc import sparse\n"
        "from quadruped_ctrl_tpu_torch.utils import checkpoint, metrics, timer\n"
        "from quadruped_ctrl_tpu_torch import cli\n"
        "from quadruped_ctrl_tpu_torch import bench, bench_latency, graft_entry\n"
        "from quadruped_ctrl_tpu_torch.parallel import _throughput_worker, mesh, multihost\n"
        "from quadruped_ctrl_tpu_torch.utils import kernels_smoke\n"
        "from quadruped_ctrl_tpu_torch.runtime import native\n"
        "from quadruped_ctrl_tpu_torch.sim import pybullet_bridge\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'quadruped_ctrl_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = _run(code)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-2000:]


def test_config_equals_the_jax_config_field_by_field():
    from quadruped_ctrl_tpu.config import default_config as jax_default_config
    from quadruped_ctrl_tpu_torch import default_config

    port, ref = default_config(), jax_default_config()
    assert type(port).__module__ == "quadruped_ctrl_tpu_torch.config"
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for sub in ("mpc", "solver"):
        assert [f.name for f in dataclasses.fields(getattr(port, sub))] == \
            [f.name for f in dataclasses.fields(getattr(ref, sub))]


def test_entry_points_default_to_the_card():
    """random_inputs, MPCInputs.from_numpy, the closed loop's constructors
    (init_state, sim_init, batch_init, Terrain.plane, sweep_commands,
    batch_terrains), the single-robot sessions (MiniCheetahModel,
    articulated_init, run_session, run_articulated_session) and the CLI
    build on cuda:0 unless told otherwise: with device="cpu" (`--device cpu`)
    they build on the CPU, and without a CUDA device and without device=
    they raise, never fall back to the CPU."""
    from quadruped_ctrl_tpu_torch import cli, default_config, device
    from quadruped_ctrl_tpu_torch.control import controller
    from quadruped_ctrl_tpu_torch.core.types import Command
    from quadruped_ctrl_tpu_torch.models.floating_base import MiniCheetahModel
    from quadruped_ctrl_tpu_torch.mpc import pipeline
    from quadruped_ctrl_tpu_torch.sim import articulated, batch_rollout, engine, rollout
    from quadruped_ctrl_tpu_torch.sim.terrain import Terrain

    assert device.resolve("cpu") == torch.device("cpu")
    inp = pipeline.random_inputs(0, 2, 4, device="cpu")
    assert inp.rpy.device.type == "cpu"
    cfg = default_config()
    gen = torch.Generator()
    cpu_plane = Terrain.plane(device="cpu")
    cpu_terrains = batch_rollout.batch_terrains(2, gen, device="cpu")
    cpu_model = MiniCheetahModel(device="cpu")
    cpu_cmd = Command.create(0.3, device="cpu")
    calls = {
        "init_state": lambda **kw: controller.init_state(cfg, **kw).core.safety_ok,
        "sim_init": lambda **kw: engine.sim_init(cfg, cpu_plane, **kw).p,
        "batch_init": lambda **kw: batch_rollout.batch_init(cfg, cpu_terrains, 2, **kw)[1].p,
        "Terrain.plane": lambda **kw: Terrain.plane(**kw).kind,
        "sweep_commands": lambda **kw: batch_rollout.sweep_commands(
            cfg, (0.0, 1.0), (-0.3, 0.3), (-0.5, 0.5), [9], 2, gen, **kw).vel,
        "batch_terrains": lambda **kw: batch_rollout.batch_terrains(2, gen, **kw).kind,
        "MiniCheetahModel": lambda **kw: MiniCheetahModel(**kw).inertias,
        "articulated_init": lambda **kw: articulated.articulated_init(
            cfg, cpu_model, cpu_plane, **kw).p,
        "run_session": lambda **kw: rollout.run_session(
            cfg, cpu_plane, cpu_cmd, n_ticks=1, **kw)[1].p,
        "run_articulated_session": lambda **kw: articulated.run_articulated_session(
            cfg, cpu_plane, cpu_cmd, n_ticks=1, model=cpu_model, **kw)[1].p,
    }
    for name, call in calls.items():
        assert call(device="cpu").device.type == "cpu", name
    assert cli.main(["sim", "--ticks", "1", "--device", "cpu"]) == 0
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is that device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.random_inputs(0, 2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.MPCInputs.from_numpy(inp.to_numpy())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for command in (["sim", "--ticks", "1"], ["sweep", "--batch", "2", "--macros", "1"],
                    ["bench"], ["latency"], ["kernels-smoke"], ["scaling"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(command)


def test_new_entry_points_default_to_the_card():
    """The native runtime, the bench and latency twins, the kernel smoke
    lane, the scale-out mesh and solve, the scaling report and the two
    graft entry points build on cuda:0 unless told otherwise: without a
    CUDA device and without device= they raise."""
    from quadruped_ctrl_tpu_torch import bench, bench_latency, default_config, graft_entry
    from quadruped_ctrl_tpu_torch.parallel import mesh, multihost
    from quadruped_ctrl_tpu_torch.runtime.native import NativeController
    from quadruped_ctrl_tpu_torch.utils.kernels_smoke import run_smoke

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is that device")
    cfg = default_config()

    def sharded_mpc_solve():
        with mesh.local_group("cpu"):
            mesh.sharded_mpc_solve(cfg, mesh.make_mesh(1), 10)

    calls = {"NativeController": NativeController, "bench.main": bench.main,
             "bench_latency.main": bench_latency.main, "run_smoke": run_smoke,
             "sharded_mpc_solve": sharded_mpc_solve, "local_group": mesh.local_group().__enter__,
             "scaling_report": lambda: multihost.scaling_report(cfg),
             "graft_entry.entry": graft_entry.entry,
             "dryrun_multichip": lambda: graft_entry.dryrun_multichip(1)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert not torch.distributed.is_initialized(), name


# (JAX module, port module) pairs whose top-level functions and classes the
# port keeps by name
NAMESAKES = [("bench.py", "quadruped_ctrl_tpu_torch.bench"),
             ("bench_latency.py", "quadruped_ctrl_tpu_torch.bench_latency"),
             ("__graft_entry__.py", "quadruped_ctrl_tpu_torch.graft_entry"),
             ("quadruped_ctrl_tpu/parallel/mesh.py", "quadruped_ctrl_tpu_torch.parallel.mesh"),
             ("quadruped_ctrl_tpu/parallel/multihost.py",
              "quadruped_ctrl_tpu_torch.parallel.multihost"),
             ("quadruped_ctrl_tpu/parallel/_throughput_worker.py",
              "quadruped_ctrl_tpu_torch.parallel._throughput_worker"),
             ("quadruped_ctrl_tpu/utils/kernels_smoke.py",
              "quadruped_ctrl_tpu_torch.utils.kernels_smoke"),
             ("quadruped_ctrl_tpu/runtime/native.py", "quadruped_ctrl_tpu_torch.runtime.native"),
             ("quadruped_ctrl_tpu/sim/pybullet_bridge.py",
              "quadruped_ctrl_tpu_torch.sim.pybullet_bridge")]


@pytest.mark.parametrize("jax_path,port_module", NAMESAKES, ids=[p for p, _ in NAMESAKES])
def test_port_defines_its_namesakes_top_level_names(jax_path, port_module):
    """Every top-level function, class and public module constant of
    the JAX file is defined in its port counterpart, and a function keeps
    the JAX positional parameters in order (the port may add keywords after
    them)."""
    import ast
    import importlib
    import inspect

    tree = ast.parse((REPO / jax_path).read_text())
    port = importlib.import_module(port_module)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            assert hasattr(port, node.name), (port_module, node.name)
        if isinstance(node, ast.FunctionDef):
            want = [a.arg for a in node.args.args]
            got = list(inspect.signature(getattr(port, node.name)).parameters)
            assert got[:len(want)] == want, (node.name, got, want)
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id.isupper() and t.id[0] != "_":
                    assert hasattr(port, t.id), (port_module, t.id)


def test_state_trees_equal_the_jax_trees_field_by_field():
    """Each port dataclass has its JAX namesake's fields, in the same order,
    and where both build a default instance, the same dtypes and shapes."""
    import jax
    import numpy as np

    from quadruped_ctrl_tpu.config import default_config as jax_default_config
    from quadruped_ctrl_tpu.control import controller as jc, desired_state as jd
    from quadruped_ctrl_tpu.core import types as jt
    from quadruped_ctrl_tpu.sim import articulated as ja, engine as je, terrain as jte
    from quadruped_ctrl_tpu_torch import default_config
    from quadruped_ctrl_tpu_torch.control import controller as tc, desired_state as td
    from quadruped_ctrl_tpu_torch.core import types as tt
    from quadruped_ctrl_tpu_torch.sim import articulated as ta, engine as te, terrain as tte

    pairs = [(getattr(jt, n), getattr(tt, n)) for n in (
        "Sensors", "Command", "StateEstimate", "EstimatorState", "LegData", "GaitParams",
        "LocomotionState", "ControllerState", "ControllerOutput")]
    pairs += [(jc.FullControllerState, tc.FullControllerState),
              (jd.DesiredStateCommandState, td.DesiredStateCommandState),
              (je.SimState, te.SimState), (jte.Terrain, tte.Terrain),
              (ja.ArticulatedState, ta.ArticulatedState)]
    for jcls, tcls in pairs:
        assert [f.name for f in dataclasses.fields(tcls)] == \
            [f.name for f in dataclasses.fields(jcls)], tcls.__name__

    cfg = default_config()
    jcfg = jax_default_config()
    built = [(jt.Command.create(0.1, 0.2, 0.3), tt.Command.create(0.1, 0.2, 0.3, device="cpu")),
             (jc.init_state(jcfg), tc.init_state(cfg, device="cpu")),
             (jte.Terrain.plane(), tte.Terrain.plane(device="cpu")),
             (je.sim_init(jcfg, jte.Terrain.plane()),
              te.sim_init(cfg, tte.Terrain.plane(device="cpu"), device="cpu"))]
    for jtree, ttree in built:
        jleaves = [np.asarray(x) for x in jax.tree.leaves(jtree)]
        tleaves = [x.numpy() for x in tt.tree_flatten(ttree)[0]]
        assert len(jleaves) == len(tleaves), type(ttree).__name__
        for a, b in zip(tleaves, jleaves):
            assert a.dtype == b.dtype and a.shape == b.shape, (type(ttree).__name__, a.dtype,
                                                               b.dtype)
            np.testing.assert_array_equal(a, b)


def test_build_module_without_nvcc(monkeypatch, tmp_path):
    from quadruped_ctrl_tpu_torch.ops import _build

    names = [p.name for p in _build.source_files()]
    assert {"ns_core.cuh", "ns_inverse.cu", "ns_refine.cu", "formation_pack.cu",
            "fused_admm.cu"} <= set(names)
    assert len(_build.source_hash()) == 16
    assert _build.library_path().parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.nvcc()


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_device_routing():
    from quadruped_ctrl_tpu_torch import device

    t = torch.zeros(2)
    assert device.use_kernels(t) is False
    assert device.use_kernels(t, True) is True
    assert device.use_kernels(t, False) is False
    assert torch.get_float32_matmul_precision() == "highest"
