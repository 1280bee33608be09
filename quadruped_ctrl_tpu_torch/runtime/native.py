"""Python binding for the native host runtime (native/quadruped_rt.cpp).

The counterpart of `quadruped_ctrl_tpu/runtime/native.py`: the exact ctypes
surface reference users already drive (init_controller / pre_work /
set_gait_type / set_robot_mode / set_robot_vel / torque_calculator
returning a StructPointer with eff[12] — reference
scripts/walking_simulation.py:26-28, 70-79, 358-381), backed by the port's
controller (`controller_step` / `pre_work`, on cuda:0 unless told
otherwise) through a registered C callback. Async commands flow through the
library's lock-free SPSC queue.

The library is built with g++ from the unchanged `native/quadruped_rt.cpp`
into the port's gitignored `_build/` directory; nothing is written under
`native/`.

The C runtime ignores the callback's return code (`torque_calculator`
returns the previous torques after a failed tick), so the binding keeps the
exception a tick raised and raises it from `pre_work` / `torque_calculator`
once the C call returns.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.ops._build import BUILD_DIR

_SRC = Path(__file__).resolve().parents[2] / "native" / "quadruped_rt.cpp"
_SO_PATH = BUILD_DIR / "libquadruped_rt.so"

COMPUTE_FN = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_double),  # imu[10]
    ctypes.POINTER(ctypes.c_double),  # leg[24]
    ctypes.c_int,                     # gait (-1 => pre_work)
    ctypes.c_int,                     # mode
    ctypes.POINTER(ctypes.c_double),  # vel[3]
    ctypes.POINTER(ctypes.c_double),  # tau_out[12]
)


class JointEff(ctypes.Structure):
    _fields_ = [("eff", ctypes.c_double * 12)]


def build(force: bool = False) -> Path:
    """Compile the native library with g++ (no external deps) into the
    port's `_build/`, unless a build newer than the source is there. The
    library is written under a temporary name and renamed into place, so
    processes building at once never load a partial file."""
    if _SO_PATH.exists() and not force:
        if _SO_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
            return _SO_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO_PATH.with_name(f"{_SO_PATH.name}.{os.getpid()}.tmp")
    subprocess.run(
        [
            "g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-Wall", "-Wextra",
            "-o", str(tmp), str(_SRC), "-lpthread",
        ],
        check=True,
    )
    os.replace(tmp, _SO_PATH)
    return _SO_PATH


def load() -> ctypes.CDLL:
    lib = ctypes.cdll.LoadLibrary(str(build()))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.init_controller.argtypes = [ctypes.c_double, dp]
    lib.init_controller.restype = None
    lib.quadruped_rt_register_compute.argtypes = [COMPUTE_FN]
    lib.quadruped_rt_register_compute.restype = None
    lib.pre_work.argtypes = [dp, dp]
    lib.pre_work.restype = None
    lib.set_gait_type.argtypes = [ctypes.c_int]
    lib.set_gait_type.restype = None
    lib.set_robot_mode.argtypes = [ctypes.c_int]
    lib.set_robot_mode.restype = None
    lib.set_robot_vel.argtypes = [dp]
    lib.set_robot_vel.restype = None
    lib.torque_calculator.argtypes = [dp, dp]
    lib.torque_calculator.restype = ctypes.POINTER(JointEff)
    lib.quadruped_rt_latency_us.restype = ctypes.c_double
    lib.quadruped_rt_latency_us.argtypes = [ctypes.c_double]
    for name in ("quadruped_rt_latency_mean_us", "quadruped_rt_latency_max_us"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_double
    for name in ("quadruped_rt_tick_count", "quadruped_rt_overruns", "quadruped_rt_now_ns"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_longlong
    lib.quadruped_rt_sleep_until_next.restype = ctypes.c_longlong
    lib.quadruped_rt_sleep_until_next.argtypes = [ctypes.c_longlong]
    return lib


class NativeController:
    """The reference FFI surface, computed by the port's controller on
    `device` (cuda:0 unless named).

    Usage (mirrors walking_simulation.py's loop):
        nc = NativeController(cfg)
        nc.init_controller(500.0, [100.0, 1.0, 0.0, 0.05])
        for _ in range(10): nc.pre_work(imu, leg)
        tau = nc.torque_calculator(imu, leg)     # (12,) np.ndarray
    """

    def __init__(self, cfg=None, mpc_iterations: int | None = None, device=None):
        from quadruped_ctrl_tpu_torch.config import default_config
        from quadruped_ctrl_tpu_torch.control import controller as ctrl

        self.cfg = cfg or default_config()
        self.device = _device.resolve(device)
        self.mpc_iterations = mpc_iterations
        self.lib = load()
        self._state = ctrl.init_state(self.cfg, device=self.device)
        self._error = None

        def compute(imu_p, leg_p, gait, mode, vel_p, tau_p):
            try:
                imu = np.ctypeslib.as_array(imu_p, (10,))
                leg = np.ctypeslib.as_array(leg_p, (24,))
                if gait < 0:
                    self._state = ctrl.pre_work(self.cfg, self._state,
                                                _sensors(imu, leg, self.device))
                    return 0
                vel = np.ctypeslib.as_array(vel_p, (3,))
                self._state, out = ctrl.controller_step(
                    self.cfg, self._state, _sensors(imu, leg, self.device),
                    _command(vel, gait, mode, self.device),
                    mpc_iterations=self.mpc_iterations)
                tau = out.tau.cpu().numpy().astype(np.float64)
                ctypes.memmove(tau_p, tau.ctypes.data, 12 * ctypes.sizeof(ctypes.c_double))
                return 0
            except Exception as e:  # noqa: BLE001 — kept, raised after the C call
                self._error = e
                return 1

        self._compute_cb = COMPUTE_FN(compute)  # keep a reference alive

    def _raise_tick_error(self):
        err, self._error = self._error, None
        if err is not None:
            raise err

    # ------------------------------------------------- reference ABI ----
    def init_controller(self, freq: float, ctrl_param):
        from quadruped_ctrl_tpu_torch.control import controller as ctrl

        arr = (ctypes.c_double * 4)(*ctrl_param)
        self.lib.init_controller(ctypes.c_double(freq), arr)
        self.lib.quadruped_rt_register_compute(self._compute_cb)
        self._state = ctrl.init_state(self.cfg, device=self.device)

    def pre_work(self, imu, leg):
        self.lib.pre_work(_darr(imu, 10), _darr(leg, 24))
        self._raise_tick_error()

    def set_gait_type(self, gait: int):
        self.lib.set_gait_type(ctypes.c_int(gait))

    def set_robot_mode(self, mode: int):
        self.lib.set_robot_mode(ctypes.c_int(mode))

    def set_robot_vel(self, vel):
        self.lib.set_robot_vel(_darr(vel, 3))

    def torque_calculator(self, imu, leg) -> np.ndarray:
        res = self.lib.torque_calculator(_darr(imu, 10), _darr(leg, 24))
        self._raise_tick_error()
        return np.array(res.contents.eff[:], dtype=np.float64)

    # ------------------------------------------------- observability ----
    def latency_summary(self) -> dict:
        return {
            "count": int(self.lib.quadruped_rt_tick_count()),
            "mean_us": float(self.lib.quadruped_rt_latency_mean_us()),
            "p50_us": float(self.lib.quadruped_rt_latency_us(50.0)),
            "p99_us": float(self.lib.quadruped_rt_latency_us(99.0)),
            "max_us": float(self.lib.quadruped_rt_latency_max_us()),
            "overruns": int(self.lib.quadruped_rt_overruns()),
        }


def _f32(values, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, dtype=np.float32), device=dev)


def _sensors(imu, leg, dev):
    """Sensors from the ABI's imu[10] = [accel(3), quat xyzw(4), gyro(3)]
    and leg[24] = [q, qd] doubles, as float32 tensors on `dev`."""
    from quadruped_ctrl_tpu_torch.core.types import Sensors

    return Sensors(quat=_f32(imu[3:7], dev), gyro=_f32(imu[7:10], dev),
                   accelerometer=_f32(imu[0:3], dev), q=_f32(leg[0:12], dev),
                   qd=_f32(leg[12:24], dev))


def _command(vel, gait: int, mode: int, dev):
    from quadruped_ctrl_tpu_torch.core.types import Command

    return Command(vel=_f32(vel, dev),
                   gait_type=_device.constant(gait, dev, torch.int32),
                   robot_mode=_device.constant(mode, dev, torch.int32))


def _darr(values, n):
    arr = (ctypes.c_double * n)()
    for i, v in enumerate(np.asarray(values, dtype=np.float64).reshape(n)):
        arr[i] = v
    return arr
