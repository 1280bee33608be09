"""The port's native runtime binding (`runtime/native.py`) on the CPU:
tests/test_native_runtime.py's four cases on the port (build and ABI round
trip, the command queue, 300 standing ticks of the SRB sim through the
FFI, the rate limiter), the FFI's torques bit-equal to direct
`controller_step` calls from the same state over 20 ticks, an error raised
inside a tick surfacing from `torque_calculator` and `pre_work`, and
`build()` writing its library under the port's `_build/` and nothing under
`native/`."""

import os

import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.control import controller as ctrl
from quadruped_ctrl_tpu_torch.core.types import Command, ControllerOutput, Sensors
from quadruped_ctrl_tpu_torch.ops._build import BUILD_DIR
from quadruped_ctrl_tpu_torch.runtime import native
from quadruped_ctrl_tpu_torch.sim import engine
from quadruped_ctrl_tpu_torch.sim.terrain import Terrain
from tests.test_torch_package import REPO, _one_thread  # noqa: F401 (autouse)

CFG = default_config()


@pytest.fixture(scope="module")
def controller():
    nc = native.NativeController(CFG, mpc_iterations=20, device="cpu")
    nc.init_controller(500.0, [100.0, 1.0, 0.0, 0.05])
    return nc


def _sensor_arrays(cfg, sim):
    s = engine.sensors_from_sim(cfg, sim)
    imu = torch.cat([s.accelerometer, s.quat, s.gyro]).numpy().astype(np.float64)
    leg = torch.cat([s.q, s.qd]).numpy().astype(np.float64)
    return imu, leg


def _f32(x):
    return torch.tensor(np.asarray(x, np.float32))


def test_build_and_abi(controller):
    sim = engine.sim_init(CFG, Terrain.plane(device="cpu"), device="cpu")
    imu, leg = _sensor_arrays(CFG, sim)
    for _ in range(3):
        controller.pre_work(imu, leg)
    tau = controller.torque_calculator(imu, leg)
    assert tau.shape == (12,) and tau.dtype == np.float64
    assert np.isfinite(tau).all()


def test_command_queue_drains(controller):
    sim = engine.sim_init(CFG, Terrain.plane(device="cpu"), device="cpu")
    imu, leg = _sensor_arrays(CFG, sim)
    controller.set_gait_type(4)
    controller.set_robot_mode(0)
    controller.set_robot_vel([0.0, 0.0, 0.0])
    tau = controller.torque_calculator(imu, leg)
    assert np.isfinite(tau).all()
    assert int(controller._state.core.locomotion.current_gait) == 4


def test_closed_loop_through_ffi(controller):
    """Drive the SRB sim through the native ABI for 300 ticks (standing)."""
    terrain = Terrain.plane(device="cpu")
    sim = engine.sim_init(CFG, terrain, device="cpu")
    controller.init_controller(500.0, [100.0, 1.0, 0.0, 0.05])
    controller.set_gait_type(4)

    imu, leg = _sensor_arrays(CFG, sim)
    for _ in range(10):
        controller.pre_work(imu, leg)

    # step the SRB sim with the FFI's torques and the controller's desired
    # forces and swing targets from the state the callback carries
    for _ in range(300):
        imu, leg = _sensor_arrays(CFG, sim)
        tau = controller.torque_calculator(imu, leg)
        assert np.isfinite(tau).all()
        st = controller._state
        out = ControllerOutput(
            tau=_f32(tau), p_foot_des=st.swing_p_cur, v_foot_des=st.swing_v_cur,
            fr_des=st.core.locomotion.fr_des, contact_state=torch.ones(4),
            swing_state=torch.zeros(4), p_body_des=torch.zeros(3), v_body_des=torch.zeros(3),
            estimate=None)
        sim = engine.sim_step(CFG, sim, out, terrain)

    z = float(sim.p[2])
    assert 0.2 < z < 0.32
    stats = controller.latency_summary()
    assert stats["count"] >= 300
    assert stats["p50_us"] > 0


def test_rate_limiter(controller):
    lib = controller.lib
    t0 = lib.quadruped_rt_now_ns()
    anchor = t0
    for _ in range(5):
        anchor = lib.quadruped_rt_sleep_until_next(anchor)
    elapsed = lib.quadruped_rt_now_ns() - t0
    assert elapsed >= 4 * 2_000_000  # ~5 periods at 500 Hz, allow slack


def test_ffi_torques_equal_direct_controller_steps():
    """20 ticks through the FFI (a trot command through the queue) against
    controller_step called directly from the same state on the same
    sensors and command: bit-equal torques and final states."""
    nc = native.NativeController(CFG, mpc_iterations=20, device="cpu")
    nc.init_controller(500.0, [100.0, 1.0, 0.0, 0.05])
    terrain = Terrain.plane(device="cpu")
    sim = engine.sim_init(CFG, terrain, device="cpu")
    imu, leg = _sensor_arrays(CFG, sim)
    for _ in range(10):
        nc.pre_work(imu, leg)
    nc.set_gait_type(9)
    nc.set_robot_mode(0)
    nc.set_robot_vel([0.3, 0.0, 0.1])
    state = nc._state
    cmd = Command(vel=_f32([0.3, 0.0, 0.1]), gait_type=torch.tensor(9, dtype=torch.int32),
                  robot_mode=torch.tensor(0, dtype=torch.int32))
    for _ in range(20):
        imu, leg = _sensor_arrays(CFG, sim)
        tau_ffi = nc.torque_calculator(imu, leg)
        sensors = Sensors(quat=_f32(imu[3:7]), gyro=_f32(imu[7:10]),
                          accelerometer=_f32(imu[0:3]), q=_f32(leg[:12]), qd=_f32(leg[12:]))
        state, out = ctrl.controller_step(CFG, state, sensors, cmd, mpc_iterations=20)
        np.testing.assert_array_equal(tau_ffi, out.tau.numpy().astype(np.float64))
        sim = engine.sim_step(CFG, sim, out, terrain)
    np.testing.assert_array_equal(nc._state.core.locomotion.fr_des.numpy(),
                                  state.core.locomotion.fr_des.numpy())


def test_tick_error_surfaces(monkeypatch):
    """The C runtime ignores the callback's return code; the binding raises
    the tick's exception once the C call returns, and the next good tick
    runs as before."""
    nc = native.NativeController(CFG, mpc_iterations=20, device="cpu")
    nc.init_controller(500.0, [100.0, 1.0, 0.0, 0.05])
    imu, leg = _sensor_arrays(CFG, engine.sim_init(CFG, Terrain.plane(device="cpu"),
                                                   device="cpu"))
    good = nc.torque_calculator(imu, leg)

    def broken(*args, **kwargs):
        raise ValueError("tick failed on purpose")

    monkeypatch.setattr(ctrl, "controller_step", broken)
    with pytest.raises(ValueError, match="tick failed on purpose"):
        nc.torque_calculator(imu, leg)
    monkeypatch.setattr(ctrl, "pre_work", broken)
    with pytest.raises(ValueError, match="tick failed on purpose"):
        nc.pre_work(imu, leg)
    monkeypatch.undo()
    assert np.isfinite(nc.torque_calculator(imu, leg)).all() and np.isfinite(good).all()


def test_build_writes_only_under_the_port_build_dir():
    """The library comes from the unchanged native/quadruped_rt.cpp and lands
    in the port's _build/; native/ gains no file. (The tracked
    native/libquadruped_rt.so is not hashed: the JAX package's tests may
    rebuild it on another worker meanwhile.)"""
    native_dir = REPO / "native"
    before = sorted(os.listdir(native_dir))
    path = native.build(force=True)
    assert path.parent == BUILD_DIR and path.exists()
    assert not list(BUILD_DIR.glob("libquadruped_rt.so.*.tmp"))
    assert sorted(os.listdir(native_dir)) == before
    assert native.build() == path
