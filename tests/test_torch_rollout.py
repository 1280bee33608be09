"""The port's scenario engine against the JAX package on the CPU: the
terrain height query, the SRB simulator's pieces, and `batch_rollout` at
batch 2 on the plane — trot at vx 0.4 for 3 macros with h_sol=10, solved
uncompressed (max_stance None) and packed (max_stance 2), and the mode-1
stand phase for 2 macros. Base positions at the JAX test's 0.02 m
(tests/test_batched_mpc_path.py:108-133); the measured gap at these inputs
is 1.2e-3-1.3e-3 m, and safety holds at the end in both packages. The gap
starts in the estimator warm-up: the per-robot Kalman filter's update at the
initial_p=100 covariance is a cancellation, and the JAX filter itself moves
its estimate by 0.016 m under a one-ulp change of P (0.049 m between its jit
and eager runs); the port's differs from it by 0.04 m there. Commands and terrains are built
once with numpy and handed to both packages; random streams are never
compared."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.core.types import Command as JCommand
from quadruped_ctrl_tpu.core.types import ControllerOutput as JControllerOutput
from quadruped_ctrl_tpu.core.types import StateEstimate as JStateEstimate
from quadruped_ctrl_tpu.sim import batch_rollout as j_br
from quadruped_ctrl_tpu.sim import engine as j_engine
from quadruped_ctrl_tpu.sim import terrain as j_terrain
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.core.types import Command, ControllerOutput, vmap
from quadruped_ctrl_tpu_torch.sim import batch_rollout as t_br
from quadruped_ctrl_tpu_torch.sim import engine as t_engine
from quadruped_ctrl_tpu_torch.sim import terrain as t_terrain
from tests.test_torch_package import _one_thread  # noqa: F401

CFG, JCFG = default_config(), jax_default_config()
B = 2
# name: (vel, gait, mode, macros, max_stance)
ROLLOUTS = {
    "trot_full": ((0.4, 0.0, 0.0), 9, 0, 3, None),
    "trot_packed": ((0.4, 0.0, 0.0), 9, 0, 3, 2),
    "stand_mode1": ((0.0, 0.0, 0.0), 9, 1, 2, None),
}


def _np_tree(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _np_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def _port_terrain(jt):
    return t_terrain.Terrain.from_numpy(_np_tree(jt), device="cpu")


def _commands(vel, gait, mode):
    arrays = dict(vel=np.tile(np.asarray(vel, np.float32), (B, 1)),
                  gait_type=np.full(B, gait, np.int32), robot_mode=np.full(B, mode, np.int32))
    return (JCommand(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            Command.from_numpy(arrays, device="cpu"))


@pytest.fixture(scope="module", params=sorted(ROLLOUTS))
def rollout(request):
    vel, gait, mode, macros, ms = ROLLOUTS[request.param]
    jterr = j_br.batch_terrains(B, jax.random.PRNGKey(3), kinds=("plane",))
    jstates, jsims = j_br.batch_init(JCFG, jterr, B)
    jcmd, tcmd = _commands(vel, gait, mode)
    jout = j_br.batch_rollout(JCFG, jstates, jsims, jcmd, jterr, macros, h_sol=10,
                              max_stance=ms)
    tterr = t_br.batch_terrains(B, torch.Generator(), kinds=("plane",), device="cpu")
    tstates, tsims = t_br.batch_init(CFG, tterr, B, device="cpu")
    tout = t_br.batch_rollout(CFG, tstates, tsims, tcmd, tterr, macros, h_sol=10,
                              max_stance=ms)
    return request.param, jout, tout


def test_batch_rollout_matches_jax(rollout):
    name, (js, jm, jrec), (ts, tm, trec) = rollout
    macros = ROLLOUTS[name][3]
    np.testing.assert_allclose(tm.p.numpy(), np.asarray(jm.p), atol=0.02)
    assert trec["p"].shape == (macros, B, 3) and trec["safety"].dtype == torch.bool
    np.testing.assert_allclose(trec["p"].numpy(), np.asarray(jrec["p"]), atol=0.02)
    assert bool(trec["safety"][-1].all()) and bool(np.asarray(jrec["safety"])[-1].all())
    assert torch.isfinite(ts.core.locomotion.fr_des).all()
    np.testing.assert_array_equal(ts.core.locomotion.mpc_fail_count.numpy(),
                                  np.asarray(js.core.locomotion.mpc_fail_count))
    np.testing.assert_array_equal(ts.core.locomotion.iteration_counter.numpy(),
                                  np.asarray(js.core.locomotion.iteration_counter))
    np.testing.assert_array_equal(ts.core.locomotion.mpc_h.numpy(),
                                  np.asarray(js.core.locomotion.mpc_h))


@pytest.mark.parametrize("kind", ["plane", "random", "stairs", "slope", "boxes"])
def test_height_at_matches_jax(kind):
    """The terrain query on every kind, the heightfield drawn with numpy."""
    rng = np.random.default_rng(5)
    grid = (16, 16)
    jt = {"plane": j_terrain.Terrain.plane(grid),
          "random": j_terrain.Terrain.from_array(rng.uniform(0, 0.05, grid), cell_size=0.1),
          "stairs": j_terrain.Terrain.stairs(grid=grid),
          "slope": j_terrain.Terrain.slope(grid=grid),
          "boxes": j_terrain.Terrain.plane(grid).with_boxes(
              centers=[[0.9, 0.0, 0.01], [1.0, 0.6, 0.25]],
              halves=[[0.35, 0.6, 0.01], [0.2, 0.2, 0.25]], yaws=[0.3, 0.0])}[kind]
    tt = _port_terrain(jt)
    x = rng.uniform(-1.5, 2.0, 64).astype(np.float32)
    y = rng.uniform(-1.0, 1.0, 64).astype(np.float32)
    want = np.asarray(j_terrain.height_at(jt, jnp.asarray(x), jnp.asarray(y)))
    got = t_terrain.height_at(tt, torch.as_tensor(x), torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    pts = np.stack([x, y, rng.uniform(-0.1, 0.6, 64).astype(np.float32)], 1)
    np.testing.assert_array_equal(
        t_terrain.box_occupancy(tt, torch.as_tensor(pts)).numpy(),
        np.asarray(j_terrain.box_occupancy(jt, jnp.asarray(pts))))


def test_port_terrain_constructors_match_jax():
    for jt, tt in ((j_terrain.Terrain.plane(), t_terrain.Terrain.plane(device="cpu")),
                   (j_terrain.Terrain.stairs(0.3, 0.04, 0.5),
                    t_terrain.Terrain.stairs(0.3, 0.04, 0.5, device="cpu")),
                   (j_terrain.Terrain.slope(0.2), t_terrain.Terrain.slope(0.2, device="cpu")),
                   (j_terrain.Terrain.from_array(np.arange(64.0).reshape(8, 8), grid=(4, 4)),
                    t_terrain.Terrain.from_array(np.arange(64.0).reshape(8, 8), grid=(4, 4),
                                                 device="cpu"))):
        ref = _np_tree(jt)
        got = tt.to_numpy()
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_allclose(got[k], ref[k], atol=1e-7, err_msg=k)
    gen = torch.Generator().manual_seed(0)
    rt = t_terrain.Terrain.random(gen, grid=(8, 8), device="cpu")
    assert int(rt.kind) == t_terrain.TERRAIN_RANDOM
    assert 0.0 <= float(rt.heightfield.min()) and float(rt.heightfield.max()) <= 0.03


def test_sim_pieces_match_jax():
    """sim_init, sensors_from_sim and one sim_step from a perturbed state and
    a controller output drawn with numpy, per lane."""
    rng = np.random.default_rng(9)
    jterr = j_br.batch_terrains(B, jax.random.PRNGKey(0), kinds=("stairs",))
    tterr = _port_terrain(jterr)
    jsim = jax.vmap(lambda t: j_engine.sim_init(JCFG, t))(jterr)
    tsim = vmap(lambda t: t_engine.sim_init(CFG, t, device="cpu"))(tterr)
    for k, v in _np_tree(jsim).items():
        np.testing.assert_allclose(getattr(tsim, k).numpy(), v, atol=1e-6, err_msg=k)
    q = rng.standard_normal((B, 4)).astype(np.float32) * 0.05
    q[:, 0] += 1.0
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    sim_np = dict(_np_tree(jsim), quat=q, v=rng.uniform(-0.3, 0.3, (B, 3)),
                  omega_body=rng.uniform(-0.3, 0.3, (B, 3)),
                  foot_vel=rng.uniform(-0.2, 0.2, (B, 4, 3)), prev_v=rng.uniform(-0.3, 0.3, (B, 3)))
    sim_np = {k: (np.asarray(v, np.float32) if np.asarray(v).dtype.kind == "f" else np.asarray(v))
              for k, v in sim_np.items()}
    jsim = j_engine.SimState(**{k: jnp.asarray(v) for k, v in sim_np.items()})
    tsim = t_engine.SimState.from_numpy(sim_np, device="cpu")

    js = jax.vmap(lambda s: j_engine.sensors_from_sim(JCFG, s))(jsim)
    ts = vmap(lambda s: t_engine.sensors_from_sim(CFG, s))(tsim)
    for k, v in _np_tree(js).items():
        np.testing.assert_allclose(getattr(ts, k).numpy(), v, atol=1e-5, rtol=1e-5, err_msg=k)

    est = {f.name: np.zeros((B, 3, 3) if f.name == "r_body" else
                            (B, 4) if f.name in ("orientation", "contact_estimate") else (B, 3),
                            np.float32) for f in dataclasses.fields(JStateEstimate)}
    out_np = dict(tau=np.zeros((B, 12), np.float32),
                  p_foot_des=sim_np["foot_pos"] + rng.uniform(-0.02, 0.05, (B, 4, 3)),
                  v_foot_des=rng.uniform(-0.5, 0.5, (B, 4, 3)),
                  fr_des=np.tile([0.0, 0.0, 22.0], (B, 4, 1)) + rng.uniform(-3, 3, (B, 4, 3)),
                  contact_state=np.array([[0.5, 0.0, 0.0, 0.5]] * B),
                  swing_state=np.array([[0.0, 0.5, 0.5, 0.0]] * B),
                  p_body_des=np.zeros((B, 3)), v_body_des=np.zeros((B, 3)))
    out_np = {k: np.asarray(v, np.float32) for k, v in out_np.items()}
    jo = JControllerOutput(**{k: jnp.asarray(v) for k, v in out_np.items()},
                           estimate=JStateEstimate(**{k: jnp.asarray(v) for k, v in est.items()}))
    to = ControllerOutput.from_numpy(dict(out_np, estimate=est), device="cpu")
    jn = jax.vmap(lambda s, o, t: j_engine.sim_step(JCFG, s, o, t))(jsim, jo, jterr)
    tn = vmap(lambda s, o, t: t_engine.sim_step(CFG, s, o, t))(tsim, to, tterr)
    for k, v in _np_tree(jn).items():
        np.testing.assert_allclose(getattr(tn, k).numpy(), v, atol=1e-6, err_msg=k)


def test_sweep_commands_and_batch_terrains():
    gen = torch.Generator().manual_seed(0)
    cmds = t_br.sweep_commands(CFG, (0.0, 1.0), (-0.3, 0.3), (-0.5, 0.5), [9, 5], 64, gen,
                               device="cpu")
    assert cmds.vel.shape == (64, 3) and cmds.vel.dtype == torch.float32
    lo = torch.tensor([0.0, -0.3, -0.5])
    hi = torch.tensor([1.0, 0.3, 0.5])
    assert ((cmds.vel >= lo) & (cmds.vel <= hi)).all()
    assert cmds.gait_type.dtype == torch.int32 and set(cmds.gait_type.tolist()) <= {9, 5}
    assert cmds.robot_mode.dtype == torch.int32 and (cmds.robot_mode == 0).all()
    terr = t_br.batch_terrains(5, gen, kinds=("plane", "random", "stairs", "slope", "boxes"),
                               grid=(8, 8), device="cpu")
    assert terr.kind.tolist() == [0, 1, 2, 3, 0]
    assert terr.heightfield.shape == (5, 8, 8)
    assert float(terr.box_half[4, :2, 2].min()) > 0 and float(terr.box_half[:4].abs().max()) == 0
