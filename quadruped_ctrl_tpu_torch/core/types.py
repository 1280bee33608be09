"""State and IO trees of the controller, and the helpers that carry them.

The counterpart of `quadruped_ctrl_tpu/core/types.py`, whose flax
`@struct.dataclass` pytrees become frozen dataclasses of tensors here. Every
tree class derives from `Tree`, which gives it `replace`, `to(device)`, a
recursive `from_numpy` / `to_numpy` over nested trees (the way state crosses
from the JAX package: a nested dict of numpy arrays), and the module's
`tree_map` / `vmap` over its tensor leaves. `vmap` is `torch.func.vmap` over
the flattened leaves, since `torch.func.vmap` maps tensors and tuples, not
dataclasses.

Dtypes are the JAX package's: int32 counters, gait numbers and modes, bool
flags, float32 everywhere else.
"""

from __future__ import annotations

import dataclasses
import sys
import typing

import numpy as np
import torch

from quadruped_ctrl_tpu_torch import device as _device


# ---------------------------------------------------------------------------
# Tree plumbing: flatten a nest of dataclasses, dicts, tuples and lists to its
# tensor leaves and back.

def tree_flatten(tree):
    """(leaves, spec): the tensors of `tree` in a fixed order, and what
    `tree_unflatten` needs to rebuild it. Dataclasses, dicts, tuples and
    lists are nodes; tensors are leaves; None and other values are kept in
    the spec. The order is `jax.tree.flatten`'s: dataclass fields as
    declared, dict keys sorted, so a checkpoint's leaves line up between
    the two packages."""
    leaves = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            return ("leaf",)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            names = [f.name for f in dataclasses.fields(node)]
            return ("dc", type(node), names, [walk(getattr(node, n)) for n in names])
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (tuple, list)):
            return (type(node).__name__, [walk(v) for v in node])
        return ("const", node)

    spec = walk(tree)
    return leaves, spec


def tree_unflatten(spec, leaves):
    """The tree `tree_flatten` described by `spec`, with `leaves` in place."""
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "leaf":
            return next(it)
        if kind == "dc":
            _, cls, names, subs = s
            return cls(**{n: build(c) for n, c in zip(names, subs)})
        if kind == "dict":
            return {k: build(c) for k, c in zip(s[1], s[2])}
        if kind in ("tuple", "list"):
            vals = [build(c) for c in s[1]]
            return tuple(vals) if kind == "tuple" else vals
        return s[1]

    return build(spec)


def tree_map(fn, tree, *rest):
    """`fn` over the tensor leaves of `tree` (and the matching leaves of
    `rest`, trees of the same structure)."""
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])


def vmap(fn):
    """`torch.func.vmap` of `fn` over axis 0 of every tensor leaf of its
    positional arguments (trees). The result is a tree of the same structure
    as `fn`'s, each leaf with the batch axis first; leaves `fn` made without
    reference to its inputs come out expanded to the batch."""

    def batched(*trees):
        leaves, spec = tree_flatten(trees)
        out_spec = []

        def flat(*xs):
            out = fn(*tree_unflatten(spec, xs))
            out_leaves, s = tree_flatten(out)
            out_spec.append(s)
            return tuple(out_leaves)

        out_leaves = torch.func.vmap(flat)(*leaves)
        return tree_unflatten(out_spec[0], out_leaves)

    return batched


def _torch_dtype(arr: np.ndarray) -> torch.dtype:
    if arr.dtype.kind == "b":
        return torch.bool
    if arr.dtype.kind in "iu":
        return torch.int32
    return torch.float32


def _field_types(cls) -> dict:
    return typing.get_type_hints(cls, vars(sys.modules[cls.__module__]))


class Tree:
    """Base of the frozen dataclasses of tensors in the port."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, dev):
        return tree_map(lambda t: t.to(dev), self)

    @classmethod
    def from_numpy(cls, arrays: dict, device=None):
        """From a nested dict of arrays keyed by field name (the JAX
        package's tree of the same name, each leaf through `np.asarray`), on
        `device`: cuda:0 unless the caller names another device. Floats
        become float32, integers int32, booleans bool."""
        dev = _device.resolve(device)
        types = _field_types(cls)
        values = {}
        for f in dataclasses.fields(cls):
            v = arrays[f.name]
            sub = types.get(f.name)
            if isinstance(v, dict) and isinstance(sub, type) and issubclass(sub, Tree):
                values[f.name] = sub.from_numpy(v, device=dev)
            else:
                arr = np.array(v)
                values[f.name] = torch.as_tensor(arr, dtype=_torch_dtype(arr), device=dev)
        return cls(**values)

    def to_numpy(self) -> dict:
        """A nested dict of numpy arrays, the inverse of `from_numpy`."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to_numpy() if isinstance(v, Tree) else v.detach().cpu().numpy()
        return out


def _f32(values, dev):
    return torch.as_tensor(values, dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# The controller's trees (the reference keeps this state in C++ members,
# ConvexMPCLocomotion.h:120-175, GaitCtrller.h:40-60).

@dataclasses.dataclass(frozen=True)
class Sensors(Tree):
    """Per-tick sensor input (the reference's imu_data[10] + leg_data[24];
    GaitCtrller.cpp:34-56)."""

    quat: torch.Tensor           # (4,) (x,y,z,w) as produced by the sim/PyBullet
    gyro: torch.Tensor           # (3,) body-frame angular velocity
    accelerometer: torch.Tensor  # (3,) body-frame linear acceleration (with +g bias)
    q: torch.Tensor              # (12,) joint angles [abad,hip,knee] x 4 legs
    qd: torch.Tensor             # (12,) joint velocities


@dataclasses.dataclass(frozen=True)
class Command(Tree):
    """Asynchronous operator command (set_robot_vel / set_gait_type /
    set_robot_mode; GaitCtrller.h:82-92)."""

    vel: torch.Tensor          # (3,) [vx, vy, wz] raw command
    gait_type: torch.Tensor    # () int32, 0..11 (+20 => omni mode)
    robot_mode: torch.Tensor   # () int32, 0 = fixed gait, 1 = adaptive "aio"

    @staticmethod
    def create(vx=0.0, vy=0.0, wz=0.0, gait_type=9, robot_mode=0, device=None):
        dev = _device.resolve(device)
        return Command(
            vel=_f32([vx, vy, wz], dev),
            gait_type=torch.tensor(gait_type, dtype=torch.int32, device=dev),
            robot_mode=torch.tensor(robot_mode, dtype=torch.int32, device=dev),
        )


@dataclasses.dataclass(frozen=True)
class StateEstimate(Tree):
    """Output block of the estimator container (StateEstimatorContainer.h:22-60)."""

    position: torch.Tensor      # (3,) world
    v_world: torch.Tensor       # (3,)
    v_body: torch.Tensor        # (3,)
    orientation: torch.Tensor   # (4,) (w,x,y,z)
    r_body: torch.Tensor        # (3,3) vBody = r_body @ vWorld
    rpy: torch.Tensor           # (3,)
    omega_body: torch.Tensor    # (3,)
    omega_world: torch.Tensor   # (3,)
    a_body: torch.Tensor        # (3,)
    a_world: torch.Tensor       # (3,)
    contact_estimate: torch.Tensor  # (4,)


@dataclasses.dataclass(frozen=True)
class EstimatorState(Tree):
    """Persistent estimator state (OrientationEstimator.cpp:56-63,
    PositionVelocityEstimator.cpp:18-57)."""

    kf_xhat: torch.Tensor       # (18,) [p, v, p_foot x4]
    kf_P: torch.Tensor          # (18,18)
    ori_ini_inv: torch.Tensor   # (4,) initial-yaw-removal quaternion
    first_visit: torch.Tensor   # () bool
    contact_phase: torch.Tensor  # (4,) commanded contact phase fed back from gait

    @staticmethod
    def create(initial_p: float = 100.0, device=None):
        dev = _device.resolve(device)
        return EstimatorState(
            kf_xhat=torch.zeros(18, dtype=torch.float32, device=dev),
            kf_P=torch.eye(18, dtype=torch.float32, device=dev) * initial_p,
            ori_ini_inv=_f32([1.0, 0.0, 0.0, 0.0], dev),
            first_visit=torch.ones((), dtype=torch.bool, device=dev),
            contact_phase=torch.full((4,), 0.5, dtype=torch.float32, device=dev),
        )


@dataclasses.dataclass(frozen=True)
class LegData(Tree):
    """Per-leg measured data (LegController.h data struct)."""

    q: torch.Tensor             # (4,3)
    qd: torch.Tensor            # (4,3)
    p: torch.Tensor             # (4,3) foot position in hip frame
    v: torch.Tensor             # (4,3) foot velocity in hip frame
    jac: torch.Tensor           # (4,3,3)


@dataclasses.dataclass(frozen=True)
class GaitParams(Tree):
    """Runtime-mutable gait definition (Gait.cpp:23-41 setGaitParam)."""

    offsets: torch.Tensor       # (4,) int32 segment offsets
    durations: torch.Tensor     # (4,) int32 stance durations in segments
    h: torch.Tensor             # () int32 horizon segments (10..16)


@dataclasses.dataclass(frozen=True)
class LocomotionState(Tree):
    """ConvexMPCLocomotion persistent state (ConvexMPCLocomotion.h:120-175).
    The fields' meaning, `mpc_h`'s sticky horizon, the warm triple and
    `aio_prev_phase` among them, is the JAX package's (its
    `core/types.py:LocomotionState`)."""

    iteration_counter: torch.Tensor     # () int32
    x_vel_des: torch.Tensor             # () filtered forward velocity command
    y_vel_des: torch.Tensor
    yaw_turn_rate: torch.Tensor
    yaw_des: torch.Tensor
    yaw_des_true: torch.Tensor
    world_position_desired: torch.Tensor  # (3,)
    stand_traj: torch.Tensor            # (6,) [x, y, z, r, p, yaw]
    rpy_int: torch.Tensor               # (3,) terrain-compensation integrals
    rpy_comp: torch.Tensor              # (3,)
    current_gait: torch.Tensor          # () int32
    first_run: torch.Tensor             # () bool
    first_swing: torch.Tensor           # (4,) bool
    swing_time_remaining: torch.Tensor  # (4,)
    swing_p0: torch.Tensor              # (4,3) swing liftoff positions (world)
    swing_pf: torch.Tensor              # (4,3) swing touchdown targets (world)
    x_comp_integral: torch.Tensor       # () height-drag integral
    f_ff: torch.Tensor                  # (4,3) body-frame feedforward forces
    fr_des: torch.Tensor                # (4,3) world-frame reaction forces (MPC out)
    aio: GaitParams                     # adaptive gait's current parameters
    mpc_h: torch.Tensor                 # () int32, the MPC horizon actually solved
    mpc_fail_count: torch.Tensor        # () int32, solver-failure events
    # temporal warm start: the pre-polish ADMM iterate of the last solve,
    # advanced by one gait segment, force-normalized; zeros = cold start
    mpc_warm_x: torch.Tensor            # (h_max,4,3)
    mpc_warm_z: torch.Tensor            # (h_max,4,5)
    mpc_warm_y: torch.Tensor            # (h_max,4,5)
    aio_prev_phase: torch.Tensor        # () f32, the aio gait's phase as of the last mode-1 tick

    @staticmethod
    def create(h_max: int = 16, device=None):
        dev = _device.resolve(device)

        def f0(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        def i32(v):
            return torch.full((), v, dtype=torch.int32, device=dev)

        return LocomotionState(
            iteration_counter=i32(0),
            x_vel_des=f0(),
            y_vel_des=f0(),
            yaw_turn_rate=f0(),
            yaw_des=f0(),
            yaw_des_true=f0(),
            world_position_desired=f0(3),
            stand_traj=f0(6),
            rpy_int=f0(3),
            rpy_comp=f0(3),
            current_gait=i32(9),
            first_run=torch.ones((), dtype=torch.bool, device=dev),
            first_swing=torch.ones(4, dtype=torch.bool, device=dev),
            swing_time_remaining=f0(4),
            swing_p0=f0(4, 3),
            swing_pf=f0(4, 3),
            x_comp_integral=f0(),
            f_ff=f0(4, 3),
            fr_des=f0(4, 3),
            aio=GaitParams(
                offsets=torch.zeros(4, dtype=torch.int32, device=dev),
                durations=torch.full((4,), 14, dtype=torch.int32, device=dev),
                h=i32(14),
            ),
            mpc_h=i32(14),
            mpc_fail_count=i32(0),
            mpc_warm_x=f0(h_max, 4, 3),
            mpc_warm_z=f0(h_max, 4, 5),
            mpc_warm_y=f0(h_max, 4, 5),
            aio_prev_phase=f0(),
        )


@dataclasses.dataclass(frozen=True)
class ControllerState(Tree):
    """Complete persistent controller state (the reference's GaitCtrller +
    members; GaitCtrller.h:40-60)."""

    estimator: EstimatorState
    locomotion: LocomotionState
    safety_ok: torch.Tensor     # () bool, latches false (GaitCtrller.cpp:108-123)
    gamepad: torch.Tensor       # (3,) deadbanded velocity command

    @staticmethod
    def create(initial_p: float = 100.0, h_max: int = 16, device=None):
        dev = _device.resolve(device)
        return ControllerState(
            estimator=EstimatorState.create(initial_p, device=dev),
            locomotion=LocomotionState.create(h_max, device=dev),
            safety_ok=torch.ones((), dtype=torch.bool, device=dev),
            gamepad=torch.zeros(3, dtype=torch.float32, device=dev),
        )


@dataclasses.dataclass(frozen=True)
class ControllerOutput(Tree):
    """Per-tick controller output: torques plus the WBC-style debug block
    (ConvexMPCLocomotion.h:93-110)."""

    tau: torch.Tensor           # (12,) joint torques
    p_foot_des: torch.Tensor    # (4,3) desired world foot positions
    v_foot_des: torch.Tensor    # (4,3)
    fr_des: torch.Tensor        # (4,3) desired reaction forces (world)
    contact_state: torch.Tensor  # (4,)
    swing_state: torch.Tensor   # (4,)
    p_body_des: torch.Tensor    # (3,)
    v_body_des: torch.Tensor    # (3,)
    estimate: StateEstimate
