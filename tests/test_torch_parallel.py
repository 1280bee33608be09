"""The port's scale-out (`parallel/`) on the CPU against the JAX package:
`sharded_mpc_solve` over 2- and 4-rank Gloo process groups (mp = 1 and 2,
the packed fast path and the per-scenario path) against the JAX
`pipeline.solve_batch` on the same inputs, at tests/test_parallel.py's
tolerances (atol 0.25 N, the all-reduced mean at rtol 1e-3);
`scaling_report` at 1 and 2 ranks; and tests/test_multiprocess.py's
two-process run (each rank's shard against the JAX packed solve of the
same lanes within 0.25 N, the all-reduced mean against the global one
within 1e-4). The ranks are spawned processes, one Gloo rank each."""

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.mpc import pipeline as TP
from quadruped_ctrl_tpu_torch.parallel import mesh as mesh_mod
from quadruped_ctrl_tpu_torch.parallel import multihost
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)

CFG = default_config()
H, BATCH = 6, 16


def _solve_rank(rank, world, port, mp, packed, iterations, arrays, out_dir):
    """One Gloo rank: its shard of `arrays` through sharded_mpc_solve;
    writes its forces and the all-reduced mean."""
    torch.set_num_threads(1)
    multihost.initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    try:
        mesh = mesh_mod.make_mesh(world, mp=mp, device="cpu")
        inputs = mesh_mod.shard_batch(TP.MPCInputs.from_numpy(arrays, device="cpu"), mesh)
        h = arrays["gait_table"].shape[1]
        forces, mean_abs = mesh_mod.sharded_mpc_solve(CFG, mesh, h, iterations=iterations,
                                                      packed=packed)(inputs)
    finally:
        torch.distributed.destroy_process_group()
    np.save(f"{out_dir}/forces{rank}.npy", forces.numpy())
    np.save(f"{out_dir}/mean{rank}.npy", mean_abs.numpy())


def _sharded(tmp_path, world, mp, arrays, packed=True, iterations=None):
    """(forces of every rank in rank order, each rank's reduced mean)."""
    tmp.spawn(_solve_rank, args=(world, mesh_mod.free_port(), mp, packed, iterations, arrays,
                                 str(tmp_path)), nprocs=world, join=True)
    forces = np.concatenate([np.load(tmp_path / f"forces{r}.npy") for r in range(world)])
    means = [float(np.load(tmp_path / f"mean{r}.npy")) for r in range(world)]
    return forces, means


def _jax_inputs(arrays):
    import jax.numpy as jnp

    from quadruped_ctrl_tpu.mpc import pipeline as JP

    return JP.MPCInputs(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.fixture(scope="module")
def arrays():
    return TP.random_inputs(1, BATCH, H, device="cpu").to_numpy()


@pytest.fixture(scope="module")
def jax_forces(arrays):
    import jax

    from quadruped_ctrl_tpu.config import default_config as jax_default_config
    from quadruped_ctrl_tpu.mpc import pipeline as JP

    jcfg = jax_default_config()
    return np.asarray(jax.jit(lambda i: JP.solve_batch(jcfg, i))(_jax_inputs(arrays)))


@pytest.mark.parametrize("world,mp,packed", [(2, 1, True), (4, 2, True), (2, 1, False)],
                         ids=["2rank", "4rank_mp2", "2rank_scenario_path"])
def test_sharded_solve_matches_jax(tmp_path, arrays, jax_forces, world, mp, packed):
    """Each rank's shard (8 or 4 scenarios: solve_packed_batch; with
    packed=False solve_batch) concatenated in rank order against the JAX
    per-scenario solve of the whole batch; every rank's all-reduced mean
    against the global mean |f|."""
    forces, means = _sharded(tmp_path, world, mp, arrays, packed=packed)
    assert forces.shape == jax_forces.shape
    # packed fast path vs per-scenario reference: same minimizer, slightly
    # different iterate schedules -> knife-edge rows may differ by ~0.1 N
    np.testing.assert_allclose(forces, jax_forces, atol=0.25)
    for m in means:
        np.testing.assert_allclose(m, float(np.abs(jax_forces).mean()), rtol=1e-3)
    assert len(set(means)) == 1


def test_scaling_report_runs():
    rep = multihost.scaling_report(CFG, device_counts=[1, 2], per_device_batch=4, h=H, reps=1,
                                   device="cpu")
    assert len(rep["rows"]) == 2
    assert rep["rows"][0]["weak_efficiency"] == 1.0
    assert rep["rows"][0]["sharding_efficiency"] == 1.0
    assert rep["rows"][1]["solves_per_s"] > 0
    assert rep["rows"][1]["sharding_efficiency"] > 0
    assert rep["backend"] == "cpu" and rep["process_group_backend"] == "gloo"
    assert rep["shared_core_virtual_devices"] is True


def test_two_process_distributed_solve(tmp_path):
    """tests/test_multiprocess.py's run on the port: two processes, 2
    devices' worth of scenarios each (h=10, 60 iterations); each rank's
    shard against the JAX packed solve of the same lanes, and the
    all-reduced statistic against the global value."""
    import jax

    from quadruped_ctrl_tpu.config import default_config as jax_default_config
    from quadruped_ctrl_tpu.mpc import pipeline as JP

    nproc, devs, per_dev, h = 2, 2, 2, 10
    batch = nproc * devs * per_dev
    arrays = TP.random_inputs(0, batch, h, device="cpu").to_numpy()
    forces, means = _sharded(tmp_path, nproc, 1, arrays, iterations=60)
    jcfg = jax_default_config()
    solve = jax.jit(lambda i: JP.solve_packed_batch(jcfg, i, iterations=60))
    per_proc = batch // nproc
    for pid in range(nproc):
        lo = pid * per_proc
        ref = np.asarray(solve(_jax_inputs({k: v[lo:lo + per_proc]
                                            for k, v in arrays.items()})))
        max_err = float(np.abs(forces[lo:lo + per_proc] - ref).max())
        assert max_err < 0.25, (pid, max_err)
    full = TP.solve_packed_batch(CFG, TP.MPCInputs.from_numpy(arrays, device="cpu"),
                                 iterations=60).numpy()
    for m in means:
        rel_err = abs(m - np.abs(full).mean()) / max(np.abs(full).mean(), 1e-9)
        assert rel_err < 1e-4, rel_err


def test_world_size_one_equals_the_local_solve():
    """At one rank the sharded solve is solve_packed_batch itself, bit for
    bit, and the reduced mean is the local sum over the local count."""
    inputs = TP.random_inputs(0, 8, H, device="cpu")
    with mesh_mod.local_group("cpu"):
        mesh = mesh_mod.make_mesh(1, device="cpu")
        assert mesh.shape == {"dp": 1, "mp": 1}
        forces, mean_abs = mesh_mod.sharded_mpc_solve(CFG, mesh, H)(
            mesh_mod.shard_batch(inputs, mesh))
    local = TP.solve_packed_batch(CFG, inputs)
    assert torch.equal(forces, local)
    assert float(mean_abs) == float(local.abs().sum() / local.numel())
