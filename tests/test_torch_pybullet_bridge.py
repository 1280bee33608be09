"""The port's PyBullet bridge (`sim/pybullet_bridge.py`) through the fake
pybullet module of tests/test_pybullet_bridge.py: the JAX bridge tests on
the port (the reference reset/stand-up sequence driving the port's
controller through the native FFI on the CPU, the imu[10]/leg[24] sensor
packing, the clear ImportError without pybullet). Only the physics stepping
is fake: the robot stays at its reset pose."""

import importlib
import sys

import numpy as np
import pytest

from tests.test_pybullet_bridge import _make_fake_pybullet
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


@pytest.fixture()
def bridge_mod(monkeypatch):
    pb, pbd = _make_fake_pybullet()
    monkeypatch.setitem(sys.modules, "pybullet", pb)
    monkeypatch.setitem(sys.modules, "pybullet_data", pbd)
    import quadruped_ctrl_tpu_torch.sim.pybullet_bridge as m
    m = importlib.reload(m)
    yield m, pb
    monkeypatch.delitem(sys.modules, "pybullet")
    monkeypatch.delitem(sys.modules, "pybullet_data")
    importlib.reload(m)


def test_bridge_reset_and_step(bridge_mod):
    m, pb = bridge_mod
    assert m.HAVE_PYBULLET
    bridge = m.PyBulletBridge(terrain="plane", gui=False, device="cpu")
    bridge.reset()                       # 10 warmups + 200 stand ticks
    # the reference reset crouch pose reached every motor joint
    for j, jid in enumerate(m.MOTOR_IDS):
        assert pb._state["joints"][jid][0] == m.INIT_POS[j]
    # 200 stand-up torque commands were applied, 12 finite torques each
    assert len(pb._state["torques"]) == 200
    taus = np.asarray(pb._state["torques"])
    assert taus.shape == (200, 12) and np.isfinite(taus).all()
    assert np.abs(taus[-1]).max() > 0.0

    bridge.set_gait(9)
    bridge.set_vel(0.4, 0.0, 0.0)
    tau = bridge.step()
    assert tau.shape == (12,) and np.isfinite(tau).all()
    assert len(bridge.base_position()) == 3
    assert bridge.controller.device.type == "cpu"


def test_bridge_sensor_packing(bridge_mod):
    """imu[10] = [accel(3), quat xyzw(4), gyro(3)], leg[24] = [q, qd] —
    walking_simulation.py:536-565 layout, with the 9.8 z-bias."""
    m, pb = bridge_mod
    bridge = m.PyBulletBridge(terrain="stairs", device="cpu")
    pb._state["base_orn"] = (0.0, 0.0, 0.0, 1.0)
    pb._state["ang_vel"] = (0.1, -0.2, 0.3)
    pb._state["lin_vel"] = (0.5, 0.0, 0.0)
    bridge.last_vel = [0.0, 0.0, 0.0]
    for j, jid in enumerate(m.MOTOR_IDS):
        pb._state["joints"][jid] = (0.01 * j, -0.02 * j)
    imu, leg = bridge._sensors()
    np.testing.assert_allclose(imu[3:7], [0, 0, 0, 1])
    np.testing.assert_allclose(imu[7:10], [0.1, -0.2, 0.3])
    np.testing.assert_allclose(imu[0], 0.5 * bridge.freq)
    np.testing.assert_allclose(imu[2], 9.8)
    np.testing.assert_allclose(leg[0:12], [0.01 * j for j in range(12)])
    np.testing.assert_allclose(leg[12:24], [-0.02 * j for j in range(12)])


def test_bridge_clear_import_error_without_pybullet():
    import quadruped_ctrl_tpu_torch.sim.pybullet_bridge as m
    if m.HAVE_PYBULLET:  # pragma: no cover - no pybullet on the CPU or card hosts
        pytest.skip("real pybullet present")
    with pytest.raises(ImportError, match="pybullet is not installed"):
        m.PyBulletBridge(device="cpu")
