"""The port's control substrate against the JAX package on the CPU: rotations,
interpolation, leg kinematics, the gait functions and the MPC reference
trajectory. Inputs are drawn with numpy from a seed and handed to both
packages; tolerances are those of the JAX package's own tests of the same
functions (tests/test_rotations.py, test_leg_kinematics.py, test_gait.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.core import interpolation as j_interp
from quadruped_ctrl_tpu.core import rotations as j_rot
from quadruped_ctrl_tpu.core.types import GaitParams as JGaitParams
from quadruped_ctrl_tpu.gait import gait as j_gait
from quadruped_ctrl_tpu.models import leg_kinematics as j_lk
from quadruped_ctrl_tpu.mpc import reference as j_ref
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.core import interpolation as t_interp
from quadruped_ctrl_tpu_torch.core import rotations as t_rot
from quadruped_ctrl_tpu_torch.core.types import GaitParams, vmap
from quadruped_ctrl_tpu_torch.gait import gait as t_gait
from quadruped_ctrl_tpu_torch.models import leg_kinematics as t_lk
from quadruped_ctrl_tpu_torch.mpc import reference as t_ref
from tests.test_torch_package import _one_thread  # noqa: F401

CFG, JCFG = default_config(), jax_default_config()
RNG_SEED = 7


def _t(a):
    return torch.as_tensor(np.array(a))


def _n(a):
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a)


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


ROT_CASES = {
    "quat_to_rot": (lambda m, q, v, rpy: m.quat_to_rot(q), 1e-6),
    "quat_to_rbody": (lambda m, q, v, rpy: m.quat_to_rbody(q), 1e-6),
    "quat_to_rpy": (lambda m, q, v, rpy: m.quat_to_rpy(q), 1e-5),
    "rpy_to_quat": (lambda m, q, v, rpy: m.rpy_to_quat(rpy), 1e-6),
    "quat_product": (lambda m, q, v, rpy: m.quat_product(q[1:], q[:-1]), 1e-6),
    "quat_integrate": (lambda m, q, v, rpy: m.quat_integrate(q, v, 0.002), 1e-6),
    "rot_z": (lambda m, q, v, rpy: m.rot_z(rpy[:, 2]), 1e-6),
    "coordinate_rotation_z": (lambda m, q, v, rpy: m.coordinate_rotation_z(rpy[:, 2]), 1e-6),
    "cross_matrix": (lambda m, q, v, rpy: m.cross_matrix(v), 1e-6),
}


@pytest.mark.parametrize("name", sorted(ROT_CASES))
def test_rotations_match_jax(name):
    rng = np.random.default_rng(RNG_SEED)
    q = _quats(rng, 16)
    v = rng.uniform(-2.0, 2.0, (16, 3)).astype(np.float32)
    rpy = rng.uniform(-1.2, 1.2, (16, 3)).astype(np.float32)
    fn, atol = ROT_CASES[name]
    want = fn(j_rot, jnp.asarray(q), jnp.asarray(v), jnp.asarray(rpy))
    got = fn(t_rot, _t(q), _t(v), _t(rpy))
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=atol)


def test_rotations_run_under_vmap():
    rng = np.random.default_rng(RNG_SEED)
    q = _quats(rng, 8)
    got = vmap(lambda x: t_rot.quat_to_rpy(x))(_t(q))
    np.testing.assert_allclose(_n(got), np.asarray(j_rot.quat_to_rpy(jnp.asarray(q))),
                               atol=1e-5)


@pytest.mark.parametrize("name", ["lerp", "cubic_bezier", "cubic_bezier_d1",
                                  "cubic_bezier_d2", "deadband"])
def test_interpolation_matches_jax(name):
    rng = np.random.default_rng(RNG_SEED)
    y0, yf = (rng.uniform(-1, 1, 32).astype(np.float32) for _ in range(2))
    x = rng.uniform(0, 1, 32).astype(np.float32)
    if name == "deadband":
        cmd = rng.uniform(-0.2, 0.2, 32).astype(np.float32)
        want = j_interp.deadband(jnp.asarray(cmd), -3.0, 3.0)
        got = t_interp.deadband(_t(cmd), -3.0, 3.0)
    else:
        want = getattr(j_interp, name)(jnp.asarray(y0), jnp.asarray(yf), jnp.asarray(x))
        got = getattr(t_interp, name)(_t(y0), _t(yf), _t(x))
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=1e-6)


def _joint_angles(rng, n):
    base = np.array([0.0, -0.8, 1.6], np.float32)
    return (base + rng.uniform(-0.4, 0.4, (n, 4, 3))).astype(np.float32)


@pytest.mark.parametrize("name", ["leg_fk", "leg_jacobian", "foot_velocity"])
def test_leg_kinematics_match_jax(name):
    rng = np.random.default_rng(RNG_SEED)
    q = _joint_angles(rng, 8)
    qd = rng.uniform(-2, 2, (8, 4, 3)).astype(np.float32)
    if name == "foot_velocity":
        jac = np.asarray(j_lk.leg_jacobian(JCFG.robot, jnp.asarray(q)))
        want = j_lk.foot_velocity(jnp.asarray(jac), jnp.asarray(qd))
        got = t_lk.foot_velocity(_t(jac), _t(qd))
    else:
        want = getattr(j_lk, name)(JCFG.robot, jnp.asarray(q))
        got = getattr(t_lk, name)(CFG.robot, _t(q))
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("knee_sign", [1.0, -1.0])
def test_leg_ik_matches_jax_and_inverts_fk(knee_sign):
    rng = np.random.default_rng(RNG_SEED)
    q = _joint_angles(rng, 8)
    if knee_sign < 0:
        q[..., 2] = -q[..., 2]
    p = np.asarray(j_lk.leg_fk(JCFG.robot, jnp.asarray(q)))
    want = np.asarray(j_lk.leg_ik(JCFG.robot, jnp.asarray(p), knee_sign))
    got = _n(t_lk.leg_ik(CFG.robot, _t(p), knee_sign))
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(_n(t_lk.leg_fk(CFG.robot, _t(got))), p, atol=2e-4)


# ---------------------------------------------------------------------------
# gait

def test_gait_tables_and_stance_bounds_match_jax():
    for a, b in zip(t_gait.gait_table_arrays(), j_gait.gait_table_arrays()):
        np.testing.assert_array_equal(a, b)
    for gaits in ([9], [1, 5, 7, 8, 9], [10], [2, 4, 11], list(range(12))):
        assert t_gait.max_simultaneous_stance(gaits) == j_gait.max_simultaneous_stance(gaits)


def _params_pair(g: int):
    jp = j_gait.params_for_gait(g)
    tp = t_gait.params_for_gait(torch.tensor(g, dtype=torch.int32))
    return jp, tp


@pytest.mark.parametrize("gait_number", [0, 1, 2, 4, 5, 7, 8, 9, 10, 11, 13, -3])
def test_gait_functions_match_jax(gait_number):
    """phase_of, contact_state, swing_state, mpc_table and the swing/stance
    times over counters that wrap several periods, per gait number
    (13 and -3 clip to the table's ends as in JAX)."""
    jp, tp = _params_pair(gait_number)
    for a, b in zip((tp.offsets, tp.durations, tp.h), (jp.offsets, jp.durations, jp.h)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(_n(a), np.asarray(b))
    ib = CFG.mpc.iterations_between_mpc
    for counter in (0, 1, 12, 13, 90, 181, 182, 1000, 5003):
        jseg, jph = j_gait.phase_of(jnp.asarray(counter, jnp.int32), ib, jp)
        tseg, tph = t_gait.phase_of(torch.tensor(counter, dtype=torch.int32), ib, tp)
        assert int(tseg) == int(jseg)
        np.testing.assert_allclose(float(tph), float(jph), atol=1e-7)
        np.testing.assert_allclose(_n(t_gait.contact_state(tph, tp)),
                                   np.asarray(j_gait.contact_state(jph, jp)), atol=1e-6)
        np.testing.assert_allclose(_n(t_gait.swing_state(tph, tp)),
                                   np.asarray(j_gait.swing_state(jph, jp)), atol=1e-6)
        np.testing.assert_array_equal(_n(t_gait.mpc_table(tseg, tp, 16)),
                                      np.asarray(j_gait.mpc_table(jseg, jp, 16)))
    np.testing.assert_allclose(_n(t_gait.swing_time(CFG.dt_mpc, tp)),
                               np.asarray(j_gait.swing_time(JCFG.dt_mpc, jp)), rtol=1e-6)
    np.testing.assert_allclose(_n(t_gait.stance_time(CFG.dt_mpc, tp)),
                               np.asarray(j_gait.stance_time(JCFG.dt_mpc, jp)), rtol=1e-6)


@pytest.mark.parametrize("h_max", [16, 12])
def test_aio_params_match_jax(h_max):
    """Every speed band of the aio reshape, at and off a phase boundary,
    against a previous shape with another horizon (the counter reset)."""
    prev = dict(offsets=np.array([0, 7, 7, 0], np.int32),
                durations=np.full(4, 7, np.int32), h=np.int32(14))
    jprev = JGaitParams(**{k: jnp.asarray(v) for k, v in prev.items()})
    tprev = GaitParams(**{k: torch.as_tensor(v) for k, v in prev.items()})
    for v_body in (0.0, 0.001, 0.1, 0.2, 0.25, 0.33, 0.4, 0.9, 1.4, 1.6, 2.5):
        for yaw in (0.0, 0.3):
            for phase in (0.0, 0.5):
                jn, jg, jr = j_gait.aio_params(jnp.float32(v_body), jnp.float32(yaw), jprev,
                                               jnp.float32(phase), h_max)
                tn, tg, tr = t_gait.aio_params(torch.tensor(v_body), torch.tensor(yaw), tprev,
                                               torch.tensor(phase), h_max)
                for a, b in ((tn.offsets, jn.offsets), (tn.durations, jn.durations),
                             (tn.h, jn.h), (tg, jg), (tr, jr)):
                    np.testing.assert_array_equal(_n(a), np.asarray(b),
                                                  err_msg=f"v {v_body} yaw {yaw} ph {phase}")


def test_mixed_gait_matches_jax():
    periods = np.array([10, 12, 14, 16], np.int32)
    ib = CFG.mpc.iterations_between_mpc
    for counter in (0, 7, 130, 999):
        jph = j_gait.mixed_phase_of(jnp.asarray(counter, jnp.int32), ib, jnp.asarray(periods))
        tph = t_gait.mixed_phase_of(torch.tensor(counter, dtype=torch.int32), ib,
                                    torch.as_tensor(periods))
        np.testing.assert_allclose(_n(tph), np.asarray(jph), atol=1e-7)
        np.testing.assert_allclose(_n(t_gait.mixed_contact_state(tph, 0.6)),
                                   np.asarray(j_gait.mixed_contact_state(jph, 0.6)), atol=1e-6)
        np.testing.assert_allclose(_n(t_gait.mixed_swing_state(tph, 0.6)),
                                   np.asarray(j_gait.mixed_swing_state(jph, 0.6)), atol=1e-6)
        np.testing.assert_array_equal(
            _n(t_gait.mixed_mpc_table(torch.tensor(counter, dtype=torch.int32), ib,
                                      torch.as_tensor(periods), 0.6, 16)),
            np.asarray(j_gait.mixed_mpc_table(jnp.asarray(counter, jnp.int32), ib,
                                              jnp.asarray(periods), 0.6, 16)))


# ---------------------------------------------------------------------------
# MPC reference trajectory

@pytest.mark.parametrize("standing", [False, True])
def test_build_reference_matches_jax(standing):
    rng = np.random.default_rng(RNG_SEED)
    args = dict(
        stand_traj=rng.uniform(-1, 1, 6), world_position_desired=rng.uniform(-1, 1, 3),
        position=rng.uniform(-1, 1, 3), rpy_comp=rng.uniform(-0.1, 0.1, 3),
        yaw_des_true=rng.uniform(-1, 1, ()), yaw_turn_rate=rng.uniform(-0.5, 0.5, ()),
        v_des_world=rng.uniform(-1, 1, 3))
    args = {k: np.asarray(v, np.float32) for k, v in args.items()}
    jt, jw = jax.jit(lambda a: j_ref.build_reference(JCFG, jnp.asarray(standing), **a, h_max=16)
                     )({k: jnp.asarray(v) for k, v in args.items()})
    tt, tw = t_ref.build_reference(CFG, torch.tensor(standing), **{k: _t(v) for k, v in args.items()},
                                   h_max=16)
    np.testing.assert_allclose(_n(tt), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(_n(tw), np.asarray(jw), atol=1e-5)
