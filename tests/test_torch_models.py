"""The port's rigid-body models against the JAX package on the CPU: every
function of `models/spatial.py` and `models/actuator.py`, and
`MiniCheetahModel`'s tree constants, kinematics, CRBA, RNEA, contact
Jacobians, forward dynamics, ABA and operational-space tools on seeded
joint states, at the tolerances of tests/test_floating_base.py and
tests/test_floating_base_aba.py; then those files' own properties on the
port (SPD mass matrix, 8.91 kg, M qdd + h = tau, ABA equal to the CRBA+RNEA
solve, actuator saturation). Inputs are drawn with numpy and handed to both
packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import RobotConfig as JRobotConfig
from quadruped_ctrl_tpu.models import actuator as j_act
from quadruped_ctrl_tpu.models import spatial as j_sp
from quadruped_ctrl_tpu.models.floating_base import MiniCheetahModel as JModel
from quadruped_ctrl_tpu_torch.config import RobotConfig
from quadruped_ctrl_tpu_torch.models import actuator as t_act
from quadruped_ctrl_tpu_torch.models import leg_kinematics as t_lk
from quadruped_ctrl_tpu_torch.models import spatial as t_sp
from quadruped_ctrl_tpu_torch.models.floating_base import N_DOF, MiniCheetahModel
from tests.test_torch_package import _one_thread  # noqa: F401

ROBOT, JROBOT = RobotConfig(), JRobotConfig()
MODEL, JMODEL = MiniCheetahModel(device="cpu"), JModel()
TOTAL_MASS = 3.3 + 4 * (0.54 + 0.634 + 0.064) + 12 * 0.055


def _state(seed):
    """(q, qd, base_vel, tau, r_body, f_feet) as float32 numpy, the ranges of
    tests/test_floating_base_aba.py."""
    rng = np.random.default_rng(seed)
    q = np.tile([0.0, -0.8, 1.6], 4) + rng.uniform(-0.3, 0.3, 12)
    ang = rng.uniform(-0.4, 0.4)
    r_body = np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
                       [np.sin(ang), 0, np.cos(ang)]])
    arrays = (q, rng.uniform(-2.0, 2.0, 12), rng.uniform(-1.0, 1.0, 6),
              rng.uniform(-5.0, 5.0, 12), r_body, rng.uniform(-30.0, 30.0, (4, 3)))
    return [np.asarray(a, np.float32) for a in arrays]


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ------------------------------------------------------------- spatial.py

SPATIAL = {
    "xform": lambda m, r: m.xform(r["rot"], r["p"]),
    "xform_rot": lambda m, r: m.xform_rot(r["x"]),
    "xform_force": lambda m, r: m.xform_force(r["x"]),
    "inv_xform": lambda m, r: m.inv_xform(r["x"]),
    "motion_cross": lambda m, r: m.motion_cross(r["v"]),
    "force_cross": lambda m, r: m.force_cross(r["v"]),
    "spatial_inertia": lambda m, r: m.spatial_inertia(r["mass"], r["com"], r["inertia"]),
    "rot_axis_0": lambda m, r: m.rot_axis(0, r["theta"]),
    "rot_axis_1": lambda m, r: m.rot_axis(1, r["theta"]),
    "rot_axis_2": lambda m, r: m.rot_axis(2, r["theta"]),
    "joint_xform": lambda m, r: m.joint_xform(1, r["theta"]),
}


@pytest.mark.parametrize("name", sorted(SPATIAL))
def test_spatial_matches_jax(name):
    rng = np.random.default_rng(len(name))
    a = rng.standard_normal((3, 3))
    rot = np.linalg.qr(a)[0]
    inertia = a @ a.T + np.eye(3)
    arrays = dict(rot=np.stack([rot, rot.T]), p=rng.standard_normal((2, 3)),
                  v=rng.standard_normal((5, 6)), theta=rng.uniform(-3, 3, (4,)),
                  mass=np.asarray(1.7), com=rng.standard_normal(3), inertia=inertia)
    arrays["x"] = np.asarray(j_sp.xform(jnp.asarray(arrays["rot"], jnp.float32),
                                        jnp.asarray(arrays["p"], jnp.float32)))
    arrays = {k: np.array(v, np.float32) for k, v in arrays.items()}
    want = SPATIAL[name](j_sp, {k: jnp.asarray(v) for k, v in arrays.items()})
    got = SPATIAL[name](t_sp, {k: torch.as_tensor(v) for k, v in arrays.items()})
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_joint_motion_subspace_matches_jax(axis):
    got = t_sp.joint_motion_subspace(axis, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_sp.joint_motion_subspace(axis)))


# ------------------------------------------------------------ actuator.py

def test_actuator_matches_jax():
    rng = np.random.default_rng(11)
    np.testing.assert_array_equal(t_act.gear_ratios(ROBOT, device="cpu").numpy(),
                                  np.asarray(j_act.gear_ratios(JROBOT)))
    for scale in (5.0, 40.0, 500.0):
        tau = rng.uniform(-scale, scale, 12).astype(np.float32)
        qd = rng.uniform(-40.0, 40.0, 12).astype(np.float32)
        want = j_act.achievable_torque(JROBOT, jnp.asarray(tau), jnp.asarray(qd))
        got = t_act.achievable_torque(ROBOT, *_t(tau, qd))
        _close(got, want, rtol=1e-6, atol=1e-5)


def test_actuator_model_saturation():
    """tests/test_floating_base.py::test_actuator_model_saturation on the port."""
    qd = torch.zeros(12)
    tau = t_act.achievable_torque(ROBOT, torch.full((12,), 5.0), qd).numpy()
    np.testing.assert_allclose(tau, 5.0, atol=0.05)
    tau = t_act.achievable_torque(ROBOT, torch.full((12,), 500.0), qd).numpy()
    np.testing.assert_allclose(tau, np.array([6.0, 6.0, 9.33] * 4) * 3.0, rtol=1e-5)
    fast = t_act.achievable_torque(ROBOT, torch.full((12,), 500.0), torch.full((12,), 35.0))
    assert (fast.numpy() < tau - 1.0).all()


# ------------------------------------------------------- floating_base.py

def test_model_constants_match_jax():
    pairs = {"x_tree": JMODEL.x_tree, "inertias": JMODEL.inertias,
             "rotor_inertia": JMODEL.rotor_inertia, "rotor_xtree": JMODEL.rotor_xtree,
             "rotor_static": JMODEL.rotor_static, "urot_parent": JMODEL.urot_parent,
             "foot_offsets": JMODEL.foot_offsets}
    for name, ref in pairs.items():
        got = getattr(MODEL, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu", name
        _close(got, np.stack([np.asarray(x) for x in ref]), atol=1e-9, err_msg=name)
    _close(MODEL.rotor_refl, JMODEL.rotor_refl, atol=0)
    assert MODEL.parents == JMODEL.parents and MODEL.gear == JMODEL.gear


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_kinematics_and_crba_rnea_match_jax(seed):
    q, qd, bv, _, r_body, _ = _state(seed)
    tq, tqd, tbv, tr = _t(q, qd, bv, r_body)
    _close(MODEL.foot_positions_base(tq), JMODEL.foot_positions_base(q), atol=1e-5)
    _close(MODEL.mass_matrix(tq), JMODEL.mass_matrix(q), atol=1e-5)
    _close(MODEL.contact_jacobians(tq), JMODEL.contact_jacobians(q), atol=1e-5)
    _close(MODEL.bias_forces(tq, tqd, tbv), JMODEL.bias_forces(q, qd, bv), atol=2e-4)
    _close(MODEL.bias_forces_oriented(tq, tqd, tbv, tr),
           JMODEL.bias_forces_oriented(q, qd, bv, r_body), atol=2e-4)


@pytest.mark.parametrize("oriented", [False, True])
def test_forward_dynamics_and_aba_match_jax(oriented):
    for seed in (7, 8):
        q, qd, bv, tau, r_body, f_feet = _state(seed)
        kw = dict(r_body=r_body, f_ext_feet=f_feet) if oriented else {}
        tkw = {k: torch.as_tensor(v) for k, v in kw.items()}
        args, targs = (q, qd, bv, tau), _t(q, qd, bv, tau)
        ref = np.asarray(JMODEL.forward_dynamics(*args, **kw))
        _close(MODEL.forward_dynamics(*targs, **tkw), ref, rtol=1e-4, atol=2e-3)
        _close(MODEL.aba(*targs, **tkw), np.asarray(JMODEL.aba(*args, **kw)),
               rtol=1e-4, atol=2e-3)
        # the port's ABA against its own CRBA+RNEA solve
        _close(MODEL.aba(*targs, **tkw), MODEL.forward_dynamics(*targs, **tkw),
               rtol=1e-4, atol=2e-3)


def test_contact_tools_and_box_match_jax():
    q = _state(9)[0]
    tq = torch.as_tensor(q)
    _close(MODEL.inv_contact_inertia(tq), JMODEL.inv_contact_inertia(q), rtol=1e-4, atol=1e-5)
    for leg in range(4):
        f = np.asarray([0.3, -0.2, 1.0], np.float32) * (leg + 1)
        dv, dqd = MODEL.apply_test_force(tq, leg, torch.as_tensor(f))
        jdv, jdqd = JMODEL.apply_test_force(q, leg, jnp.asarray(f))
        _close(dv, jdv, rtol=1e-4, atol=1e-5)
        _close(dqd, jdqd, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(MODEL.box_contact_points().numpy(),
                                  np.asarray(JMODEL.box_contact_points()))
    np.testing.assert_array_equal(MODEL.box_point_jacobians().numpy(),
                                  np.asarray(JMODEL.box_point_jacobians()))
    base_p, r_body = np.asarray([1.0, 2.0, 0.3], np.float32), _state(9)[4]
    _close(MODEL.box_point_positions_world(*_t(base_p, r_body)),
           JMODEL.box_point_positions_world(jnp.asarray(base_p), jnp.asarray(r_body)),
           atol=1e-6)


# ------------------------------------------- the JAX tests' properties, on the port

def test_foot_positions_match_leg_kinematics():
    hips = torch.as_tensor(ROBOT.hip_locations(), dtype=torch.float32)
    for seed in (1, 2):
        q = torch.as_tensor(_state(seed)[0])
        want = hips + t_lk.leg_fk(ROBOT, q.reshape(4, 3))
        _close(MODEL.foot_positions_base(q), want, atol=1e-5)


def test_mass_matrix_spd_and_total_mass():
    m = MODEL.mass_matrix(torch.as_tensor(_state(3)[0])).numpy().astype(np.float64)
    np.testing.assert_allclose(m, m.T, atol=1e-5)
    assert np.linalg.eigvalsh(m).min() > 0
    np.testing.assert_allclose(np.diag(m[3:6, 3:6]), TOTAL_MASS, rtol=1e-5)
    np.testing.assert_allclose(m[3:6, 3:6] - np.diag(np.diag(m[3:6, 3:6])), 0, atol=1e-6)


def test_gravity_torques():
    q = torch.as_tensor(np.tile([0.0, -0.8, 1.6], 4).astype(np.float32))
    h = MODEL.bias_forces(q, torch.zeros(12), torch.zeros(6)).numpy()
    np.testing.assert_allclose(h[5], TOTAL_MASS * 9.81, rtol=1e-4)


def test_rnea_crba_consistency():
    q, qd, bv, tau = _t(*_state(4)[:4])
    qdd = MODEL.forward_dynamics(q, qd, bv, tau)
    lhs = MODEL.mass_matrix(q) @ qdd + MODEL.bias_forces(q, qd, bv)
    _close(lhs, np.concatenate([np.zeros(6), tau.numpy()]), atol=2e-4)


def test_contact_jacobian_matches_autograd():
    q = torch.as_tensor(_state(5)[0])
    jac = MODEL.contact_jacobians(q).numpy()
    fd = torch.autograd.functional.jacobian(MODEL.foot_positions_base, q).numpy()
    np.testing.assert_allclose(jac[:, :, 6:18], fd, atol=1e-4)
    feet = MODEL.foot_positions_base(q).numpy()
    jl = t_lk.leg_jacobian(ROBOT, q.reshape(4, 3)).numpy()
    for leg in range(4):
        np.testing.assert_allclose(jac[leg, :, 3:6], np.eye(3), atol=1e-6)
        p = feet[leg]
        px = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])
        np.testing.assert_allclose(jac[leg, :, 0:3], -px, atol=1e-5)
        np.testing.assert_allclose(jac[leg, :, 6 + 3 * leg:9 + 3 * leg], jl[leg], atol=1e-5)


def test_inv_contact_inertia_spd_and_test_force():
    q = torch.as_tensor(_state(6)[0])
    lam_inv = MODEL.inv_contact_inertia(q).numpy()
    assert lam_inv.shape == (12, 12)
    np.testing.assert_allclose(lam_inv, lam_inv.T, atol=1e-4)
    assert np.linalg.eigvalsh(0.5 * (lam_inv + lam_inv.T)).min() > 0.0
    for axis in range(3):
        e = torch.zeros(3)
        e[axis] = 1.0
        dv, _ = MODEL.apply_test_force(q, 1, e)
        np.testing.assert_allclose(dv.numpy(), lam_inv[3:6, 3 + axis], rtol=1e-4, atol=1e-5)
    dv, dqd = MODEL.apply_test_force(q, 0, torch.as_tensor([0.0, 0.0, 1.0]))
    assert float(dv[2]) > 0.0 and dqd.shape == (N_DOF,)


def test_box_contact_points():
    pts = MODEL.box_contact_points().numpy()
    r = MODEL.robot
    np.testing.assert_allclose(
        np.abs(pts), np.tile([[r.body_length / 2, r.body_width / 2, r.body_height / 2]],
                             (8, 1)))
    assert len({tuple(p) for p in pts.tolist()}) == 8
    jac = MODEL.box_point_jacobians().numpy()
    v = jac @ np.concatenate([np.zeros(3), [0.0, 0.0, 1.0], np.zeros(12)])
    np.testing.assert_allclose(v, np.tile([[0.0, 0.0, 1.0]], (8, 1)))
    omega = np.array([0.0, 0.0, 2.0])
    v = jac @ np.concatenate([omega, np.zeros(15)])
    np.testing.assert_allclose(v, np.cross(np.tile(omega, (8, 1)), pts), atol=1e-6)
