"""The port's single-robot sessions and the modules around them, against the
JAX package on the CPU:

- `sim/rollout.py`: `make_command_sequence`, and `run_session` of 300 ticks
  (vx 0.5 trot after the 200-tick stand) with base positions within 0.02 m
  (the closed-loop gate of tests/test_torch_rollout.py); then one port-only
  trot session of 1000 ticks held to tests/test_closed_loop.py's trot gates
  on `tracking_metrics`' tail (its second half);
- `estimation/cheater.py`: `cheater_estimate` field by field, and
  tests/test_parity_extras.py's own check;
- `mpc/sparse.py`: `build_sparse_qp` and `solve_sparse` against JAX, and
  against the port's dense path with tests/test_sparse_mpc.py's gates (3 N on
  the first step's fz, 12 N overall); `random_inputs(trot=False)`'s gait
  table against JAX's;
- `sim/camera.py`: depth, masks, point cloud, RGB and mono8 on the plane,
  stairs, a slope and a box prop, with and without the robot in frame.

Inputs are drawn with numpy and handed to both packages; terrains cross by
`Terrain.from_numpy`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.core import rotations as j_rot
from quadruped_ctrl_tpu.core.types import Command as JCommand
from quadruped_ctrl_tpu.estimation.cheater import cheater_estimate as j_cheater
from quadruped_ctrl_tpu.mpc import pipeline as j_pipe
from quadruped_ctrl_tpu.mpc import sparse as j_sparse
from quadruped_ctrl_tpu.sim import camera as j_cam
from quadruped_ctrl_tpu.sim import rollout as j_rollout
from quadruped_ctrl_tpu.sim.terrain import Terrain as JTerrain
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.core import rotations as t_rot
from quadruped_ctrl_tpu_torch.core.types import Command, tree_map
from quadruped_ctrl_tpu_torch.estimation.cheater import cheater_estimate
from quadruped_ctrl_tpu_torch.mpc import pipeline as t_pipe
from quadruped_ctrl_tpu_torch.mpc import sparse as t_sparse
from quadruped_ctrl_tpu_torch.sim import camera as t_cam
from quadruped_ctrl_tpu_torch.sim import rollout as t_rollout
from quadruped_ctrl_tpu_torch.sim.terrain import Terrain
from quadruped_ctrl_tpu_torch.utils.metrics import tracking_metrics
from tests.test_torch_package import _one_thread  # noqa: F401

CFG, JCFG = default_config(), jax_default_config()
TROT = (0.5, 0.0, 0.0)


def _np_tree(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _np_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def _port_terrain(jt):
    return Terrain.from_numpy(_np_tree(jt), device="cpu")


# ------------------------------------------------------------- rollout.py

def test_make_command_sequence_matches_jax():
    jcmds = j_rollout.make_command_sequence(JCFG, 12, JCommand.create(0.3, -0.1, 0.2, 10, 0),
                                            stand_ticks=5)
    tcmds = t_rollout.make_command_sequence(
        CFG, 12, Command.create(0.3, -0.1, 0.2, 10, 0, device="cpu"), stand_ticks=5)
    for f in ("vel", "gait_type", "robot_mode"):
        want = np.asarray(getattr(jcmds, f))
        got = getattr(tcmds, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.fixture(scope="module")
def sessions():
    n = 300
    jout = j_rollout.run_session(JCFG, JTerrain.plane(), JCommand.create(*TROT, gait_type=9),
                                 n_ticks=n)
    tout = t_rollout.run_session(CFG, Terrain.plane(device="cpu"),
                                 Command.create(*TROT, gait_type=9, device="cpu"),
                                 n_ticks=n, device="cpu")
    return jout, tout


def test_run_session_matches_jax(sessions):
    (jstate, jsim, jtraj), (tstate, tsim, ttraj) = sessions
    assert sorted(ttraj) == sorted(jtraj)
    for k, v in ttraj.items():
        want = np.asarray(jtraj[k])
        assert tuple(v.shape) == want.shape and v.numpy().dtype == want.dtype, k
    np.testing.assert_allclose(ttraj["p"].numpy(), np.asarray(jtraj["p"]), atol=0.02)
    np.testing.assert_allclose(tsim.p.numpy(), np.asarray(jsim.p), atol=0.02)
    np.testing.assert_array_equal(ttraj["contact"].numpy(), np.asarray(jtraj["contact"]))
    assert bool(ttraj["safety"].all()) and bool(np.asarray(jtraj["safety"]).all())
    for f in ("iteration_counter", "mpc_h", "current_gait"):
        np.testing.assert_array_equal(getattr(tstate.core.locomotion, f).numpy(),
                                      np.asarray(getattr(jstate.core.locomotion, f)), err_msg=f)


def test_trot_session_tracks_forward_velocity():
    """tests/test_closed_loop.py::test_trot_tracks_forward_velocity's gates on
    the port, over `tracking_metrics`' tail of a 1000-tick session (the
    length `chip_smoke.py` runs `cli sim` at on the card)."""
    _, _, traj = t_rollout.run_session(CFG, Terrain.plane(device="cpu"),
                                       Command.create(*TROT, gait_type=9, device="cpu"),
                                       n_ticks=1000, device="cpu")
    m = tracking_metrics(traj, TROT[:2], CFG.control.body_height)
    tail = traj["p"][500:, 2]
    assert m["vx_err"] < 0.1, m
    assert 0.22 < float(tail.min()) and float(tail.max()) < 0.30
    assert m["safety_ok"] and not m["fell"]


# ------------------------------------------------------------- cheater.py

def test_cheater_estimate_matches_jax():
    rng = np.random.default_rng(4)
    arrays = [rng.uniform(-1, 1, 3), rng.uniform(-0.3, 0.3, 3), rng.uniform(-1, 1, 3),
              rng.uniform(-1, 1, 3), rng.uniform(-2, 2, 3), rng.uniform(0, 1, 4)]
    pos, rpy, v, omega, acc, contact = [np.asarray(a, np.float32) for a in arrays]
    jq = j_rot.rpy_to_quat(jnp.asarray(rpy))
    tq = torch.as_tensor(np.array(jq))
    for extra in ({}, {"a_body": acc, "contact_phase": contact}):
        want = j_cheater(jnp.asarray(pos), jq, jnp.asarray(v), jnp.asarray(omega),
                         **{k: jnp.asarray(x) for k, x in extra.items()})
        got = cheater_estimate(torch.as_tensor(pos), tq,
                               torch.as_tensor(v), torch.as_tensor(omega),
                               **{k: torch.as_tensor(x) for k, x in extra.items()})
        for f in dataclasses.fields(got):
            np.testing.assert_allclose(getattr(got, f.name).numpy(),
                                       np.asarray(getattr(want, f.name)), atol=1e-6,
                                       err_msg=f.name)


def test_cheater_estimate():
    """tests/test_parity_extras.py::test_cheater_estimate on the port."""
    q = t_rot.rpy_to_quat(torch.as_tensor([0.0, 0.0, 0.5]))
    se = cheater_estimate(torch.as_tensor([1.0, 2.0, 0.28]), q,
                          torch.as_tensor([0.5, 0.0, 0.0]), torch.zeros(3))
    np.testing.assert_allclose(se.rpy.numpy()[2], 0.5, atol=1e-6)
    np.testing.assert_allclose(se.v_body.numpy(), [0.5 * np.cos(0.5), -0.5 * np.sin(0.5), 0.0],
                               atol=1e-6)


# -------------------------------------------------------------- sparse.py

H_SPARSE = 6


@pytest.fixture(scope="module")
def sparse_inputs():
    inp = t_pipe.random_inputs(7, 3, H_SPARSE, device="cpu")
    jinp = j_pipe.MPCInputs(**{k: jnp.asarray(v) for k, v in inp.to_numpy().items()})
    return [(tree_map(lambda t: t[b], inp), jax.tree.map(lambda x: x[b], jinp))
            for b in range(3)]


def test_build_sparse_qp_matches_jax(sparse_inputs):
    for tinp, jinp in sparse_inputs:
        for kw in ({}, {"weights": CFG.mpc.weights, "mu": CFG.mpc.mu}):
            got = t_sparse.build_sparse_qp(CFG, tinp, H_SPARSE, **kw)
            want = j_sparse.build_sparse_qp(JCFG, jinp, H_SPARSE, **kw)
            for name, a, b in zip(("hess", "grad", "a_mat", "l", "u"), got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6,
                                           err_msg=name)


def test_solve_sparse_matches_jax_and_the_dense_path(sparse_inputs):
    kw = dict(weights=CFG.mpc.weights, mu=CFG.mpc.mu, iterations=250, polish_rounds=8)
    jsolve = jax.jit(lambda i: j_sparse.solve_sparse(JCFG, i, **kw))
    for tinp, jinp in sparse_inputs:
        f_sparse = t_sparse.solve_sparse(CFG, tinp, **kw).numpy()
        f_dense = t_pipe.solve(CFG, tinp).numpy()
        for ref in (np.asarray(jsolve(jinp)), f_dense):
            np.testing.assert_allclose(f_sparse[0][:, 2], ref[0][:, 2], atol=3.0)
            np.testing.assert_allclose(f_sparse[0], ref[0], atol=12.0)


def test_sparse_default_weights_run(sparse_inputs):
    """tests/test_sparse_mpc.py::test_sparse_default_weights_run on the port."""
    inp = sparse_inputs[0][0]
    f = t_sparse.solve_sparse(CFG, inp).numpy()
    assert np.isfinite(f).all()
    gait = inp.gait_table.numpy()
    assert np.abs(f[gait == 0]).max() < 0.5
    fz = f[..., 2]
    assert fz.max() <= CFG.mpc.f_max + 0.5
    assert (np.abs(f[..., 0]) <= t_sparse.SPARSE_MU * fz + 0.5).all()


@pytest.mark.parametrize("trot", [True, False])
def test_random_inputs_gait_table_matches_jax(trot):
    want = np.asarray(j_pipe.random_inputs(jax.random.PRNGKey(5), 3, 8, trot=trot).gait_table)
    got = t_pipe.random_inputs(5, 3, 8, trot=trot, device="cpu").gait_table.numpy()
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- camera.py

SCENES = {
    "plane": lambda: JTerrain.plane(),
    "stairs": lambda: JTerrain.stairs(depth=0.2, height=0.05, x0=0.4),
    "slope": lambda: JTerrain.slope(0.2),
    "crate": lambda: JTerrain.plane().with_boxes(centers=[[0.8, 0.0, 0.15]],
                                                 halves=[[0.1, 0.3, 0.15]]),
}
# front legs reaching forward into the frustum (tests/test_camera.py)
ROBOT_Q = np.array([[0.0, 1.2, -0.4], [0.0, 1.2, -0.4],
                    [0.0, -0.8, 1.6], [0.0, -0.8, 1.6]], np.float32)


@pytest.mark.parametrize("robot", [False, True])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_camera_matches_jax(scene, robot):
    jt = SCENES[scene]()
    tt = _port_terrain(jt)
    p = np.asarray([0.05, -0.02, 0.3], np.float32)
    quat = np.asarray([0.999, 0.01, 0.03, 0.02])
    quat = (quat / np.linalg.norm(quat)).astype(np.float32)
    jargs, targs = (jt, jnp.asarray(p), jnp.asarray(quat)), (tt, *map(torch.as_tensor, (p, quat)))
    jkw = {"robot": (JCFG.robot, jnp.asarray(ROBOT_Q))} if robot else {}
    tkw = {"robot": (CFG.robot, torch.as_tensor(ROBOT_Q))} if robot else {}

    want = j_cam.render_depth(*jargs, **jkw)
    got = t_cam.render_depth(*targs, **tkw)
    for name, a, b in zip(("depth", "dirs", "eye"), got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)
    for name, a, b in zip(("is_robot", "is_prop"), got[3:], want[3:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert bool(got[3].any()) == robot and bool(got[4].any()) == (scene == "crate")

    pts, valid = t_cam.point_cloud(*targs, **tkw)
    jpts, jvalid = j_cam.point_cloud(*jargs, **jkw)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-5)
    for fn in ("render_rgb", "render_image"):
        a = getattr(t_cam, fn)(*targs, **tkw).numpy()
        b = np.asarray(getattr(j_cam, fn)(*jargs, **jkw))
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, fn
