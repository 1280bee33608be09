"""The port's articulated (18-DoF) simulator against the JAX package on the
CPU: `articulated_init`, `sensors_from_articulated`, the penalty contact and
20 `articulated_step`s under a PD torque from a perturbed state, then a
closed-loop `run_articulated_session` of 100 ticks (60 of them the mode-1
stand) through the controller, base position within the closed-loop tests'
0.02 m (tests/test_torch_rollout.py), the torque bound and safety of
tests/test_articulated.py. Then tests/test_articulated.py's passive-settle
gates and the singular-leg sensor bound on the port alone. Inputs are drawn
with numpy and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.core import rotations as j_rot
from quadruped_ctrl_tpu.core.types import Command as JCommand
from quadruped_ctrl_tpu.models.floating_base import MiniCheetahModel as JModel
from quadruped_ctrl_tpu.sim import articulated as j_art
from quadruped_ctrl_tpu.sim.terrain import Terrain as JTerrain
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.core.types import Command
from quadruped_ctrl_tpu_torch.models import leg_kinematics as t_lk
from quadruped_ctrl_tpu_torch.models.floating_base import MiniCheetahModel
from quadruped_ctrl_tpu_torch.sim import articulated as t_art
from quadruped_ctrl_tpu_torch.sim import engine as t_engine
from quadruped_ctrl_tpu_torch.sim.terrain import Terrain
from tests.test_torch_package import _one_thread  # noqa: F401

CFG, JCFG = default_config(), jax_default_config()
MODEL, JMODEL = MiniCheetahModel(device="cpu"), JModel()
PLANE, JPLANE = Terrain.plane(device="cpu"), JTerrain.plane()
FIELDS = ("p", "quat", "base_vel", "q", "qd", "prev_v_world")


def _np_state(st):
    return {f: np.asarray(getattr(st, f)) for f in FIELDS}


def _perturbed(seed, dz=0.0):
    """A settled-crouch state with every field moved by a seeded draw."""
    rng = np.random.default_rng(seed)
    st = _np_state(j_art.articulated_init(JCFG, JMODEL, JPLANE))
    quat = np.asarray([1.0, *rng.uniform(-0.05, 0.05, 3)])
    st.update(p=st["p"] + np.asarray([0.0, 0.0, dz]) + rng.uniform(-0.01, 0.01, 3),
              quat=quat / np.linalg.norm(quat),
              base_vel=rng.uniform(-0.3, 0.3, 6), q=st["q"] + rng.uniform(-0.1, 0.1, 12),
              qd=rng.uniform(-1.0, 1.0, 12), prev_v_world=rng.uniform(-0.2, 0.2, 3))
    st = {k: np.asarray(v, np.float32) for k, v in st.items()}
    return (j_art.ArticulatedState(**{k: jnp.asarray(v) for k, v in st.items()}),
            t_art.ArticulatedState.from_numpy(st, device="cpu"))


def _assert_state_close(tst, jst, atol):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)),
                                   atol=atol, err_msg=f)


def test_articulated_init_matches_jax():
    got = t_art.articulated_init(CFG, MODEL, PLANE, device="cpu")
    _assert_state_close(got, j_art.articulated_init(JCFG, JMODEL, JPLANE), atol=1e-6)
    assert all(getattr(got, f).dtype == torch.float32 for f in FIELDS)


def test_sensors_and_contact_match_jax():
    jst, tst = _perturbed(1, dz=-0.004)
    js, ts = j_art.sensors_from_articulated(JCFG, jst), t_art.sensors_from_articulated(CFG, tst)
    for f in ("quat", "gyro", "accelerometer", "q", "qd"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   atol=1e-4, err_msg=f)
    r = np.array(j_rot.quat_to_rot(jst.quat))
    jf, jfeet = j_art._contact_forces(JCFG, JMODEL, jst, JPLANE, jnp.asarray(r))
    tf, tfeet = t_art._contact_forces(CFG, MODEL, tst, PLANE, torch.as_tensor(r))
    assert (np.asarray(jf)[:, 2] > 0).any(), "the perturbed state has feet in contact"
    np.testing.assert_allclose(tfeet.numpy(), np.asarray(jfeet), atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-3)


def test_articulated_steps_match_jax():
    """20 ticks (80 substeps) under tau = 40 (q0 - q) - qd from a perturbed
    state with feet in contact. The positions (p, quat, q) agree within
    1e-3. The velocities are the stiff penalty contact's: the JAX step moves
    them by up to ~0.3 rad/s under a one-ulp change of the base height, so
    they are held within twice that spread, measured here."""
    jst, tst = _perturbed(2, dz=-0.003)
    q0 = np.array(jst.q)
    jstep = jax.jit(lambda st: j_art.articulated_step(
        JCFG, JMODEL, st, 40.0 * (jnp.asarray(q0) - st.q) - st.qd, JPLANE))
    jnudged = jst.replace(p=jst.p * (1.0 + 2.0 ** -23))
    tq0 = torch.as_tensor(q0)
    for _ in range(20):
        jst, jnudged = jstep(jst), jstep(jnudged)
        tst = t_art.articulated_step(CFG, MODEL, tst, 40.0 * (tq0 - tst.q) - tst.qd, PLANE)
    for f in ("p", "quat", "q"):
        np.testing.assert_allclose(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)),
                                   atol=1e-3, err_msg=f)
    for f in ("base_vel", "qd", "prev_v_world"):
        ref = np.asarray(getattr(jst, f))
        spread = np.abs(np.asarray(getattr(jnudged, f)) - ref).max()
        assert np.abs(getattr(tst, f).numpy() - ref).max() <= 2.0 * spread + 1e-4, f


@pytest.fixture(scope="module")
def sessions():
    """run_articulated_session at vx 0.5 trot, 100 ticks, 60 of them the
    stand, in both packages."""
    kw = dict(n_ticks=100, stand_ticks=60)
    jout = j_art.run_articulated_session(JCFG, JPLANE, JCommand.create(0.5, 0.0, 0.0),
                                         model=JMODEL, **kw)
    tout = t_art.run_articulated_session(CFG, PLANE, Command.create(0.5, 0.0, 0.0,
                                                                    device="cpu"),
                                         model=MODEL, device="cpu", **kw)
    return jout, tout


def test_articulated_session_matches_jax(sessions):
    (_, jsim, jtraj), (tstate, tsim, ttraj) = sessions
    assert sorted(ttraj) == sorted(jtraj)
    for k, v in ttraj.items():
        assert tuple(v.shape) == np.asarray(jtraj[k]).shape, k
    np.testing.assert_allclose(ttraj["p"].numpy(), np.asarray(jtraj["p"]), atol=0.02)
    np.testing.assert_allclose(tsim.p.numpy(), np.asarray(jsim.p), atol=0.02)
    assert bool(ttraj["safety"][-1]) and bool(np.asarray(jtraj["safety"])[-1])
    assert float(ttraj["tau"].abs().max()) < 30.0
    assert all(bool(torch.isfinite(v.float()).all()) for v in ttraj.values())
    assert 0.22 < float(ttraj["p"][-40:, 2].mean()) < 0.30
    assert int(tstate.core.locomotion.iteration_counter) == 100


def test_passive_settle():
    """tests/test_articulated.py::test_passive_settle on the port."""
    st = t_art.articulated_init(CFG, MODEL, PLANE, device="cpu")
    q0 = st.q
    for _ in range(400):
        st = t_art.articulated_step(CFG, MODEL, st, 40.0 * (q0 - st.q) - 1.0 * st.qd, PLANE)
    assert 0.2 < float(st.p[2]) < 0.3
    assert float(st.qd.abs().max()) < 0.5


def test_sensors_qd_bounded_at_singular_leg():
    """tests/test_articulated.py::test_sensors_qd_bounded_at_singular_leg on
    the port's SRB sensors: at knee full extension the damped solve returns
    bounded joint velocities."""
    sim = t_engine.sim_init(CFG, PLANE, device="cpu")
    foot_hip = t_lk.leg_fk(CFG.robot, torch.zeros((4, 3)))
    hips = torch.as_tensor(CFG.robot.hip_locations(), dtype=torch.float32)
    sim = sim.replace(foot_pos=sim.p[None, :] + hips + foot_hip,
                      foot_vel=torch.full((4, 3), 0.5),
                      p=sim.p + torch.as_tensor([0.0, 0.0, 0.05]))
    qd = t_engine.sensors_from_sim(CFG, sim).qd
    assert bool(torch.isfinite(qd).all()) and float(qd.abs().max()) < 1e4
