"""The port's controller against the JAX package on the CPU.

State crosses from the JAX package as nested dicts of numpy arrays
(`Tree.from_numpy`): both packages then compute from the same state. The
batch of 4 robots is the JAX test's (`tests/test_batched_mpc_path.py`:
crouch joint angles with small noise, trot at vx in [0, 0.8], three control
ticks in), drawn here with numpy from seed 0. Tolerances are the JAX tests':
the control tick's leaves at 1e-5 (integers and flags exact), the solve's
`fr_des` and `f_ff` at 0.15 N (test_batched_mpc_path.py:58) and
`world_position_desired` at 1e-6. The solve compares the port's plain branch
with the JAX package's XLA branch, two orders of arithmetic: seed 0's
largest force difference in these cases is below 0.01 N, far inside 0.15 N.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.control import controller as j_ctrl
from quadruped_ctrl_tpu.core.types import Command as JCommand
from quadruped_ctrl_tpu.core.types import Sensors as JSensors
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.control import controller as t_ctrl
from quadruped_ctrl_tpu_torch.core.types import (
    Command,
    GaitParams,
    LegData,
    Sensors,
    StateEstimate,
    vmap,
)
from quadruped_ctrl_tpu_torch.solver import admm as t_admm
from tests.test_torch_package import _one_thread  # noqa: F401

CFG, JCFG = default_config(), jax_default_config()
BATCH = 4
SEED = 0


def to_numpy_tree(obj):
    """A JAX tree (flax dataclasses, dicts) as nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_numpy_tree(v) for k, v in obj.items()}
    return np.asarray(obj)


def port_state(jstate):
    return t_ctrl.FullControllerState.from_numpy(to_numpy_tree(jstate), device="cpu")


def port_ctx(jctx):
    trees = {"se": StateEstimate, "leg": LegData, "params": GaitParams}
    out = {}
    for k, v in to_numpy_tree(jctx).items():
        if k in trees:
            out[k] = trees[k].from_numpy(v, device="cpu")
        else:
            dtype = {"b": torch.bool, "i": torch.int32}.get(v.dtype.kind, torch.float32)
            out[k] = torch.as_tensor(np.array(v), dtype=dtype)
    return out


def assert_tree_close(port, ref, atol, path=""):
    """Every leaf of the port's tree (a Tree or a dict of them) against the
    JAX tree's numpy dict: floats at atol, integers and bools exact, with
    equal dtypes (int32, bool, float32)."""
    ref = to_numpy_tree(ref)
    got = port.to_numpy() if hasattr(port, "to_numpy") else {
        k: (v.to_numpy() if hasattr(v, "to_numpy") else v.numpy()) for k, v in port.items()}

    def walk(a, b, p):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), p
            for k in b:
                walk(a[k], b[k], f"{p}.{k}")
            return
        assert a.shape == b.shape, p
        assert a.dtype == b.dtype, f"{p}: {a.dtype} vs {b.dtype}"
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=p)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=atol, err_msg=p)

    walk(got, ref, path)


def _inputs():
    """Per-robot sensors and commands (numpy, leading axis BATCH)."""
    rng = np.random.default_rng(SEED)
    q = np.tile([0.0, -0.8, 1.6], 4) + rng.uniform(-0.05, 0.05, (BATCH, 12))
    sensors = dict(
        quat=np.tile([0.0, 0.0, 0.0, 1.0], (BATCH, 1)),
        gyro=rng.uniform(-0.1, 0.1, (BATCH, 3)),
        accelerometer=np.tile([0.0, 0.0, 9.8], (BATCH, 1)),
        q=q, qd=rng.uniform(-0.2, 0.2, (BATCH, 12)))
    vx = rng.uniform(0.0, 0.8, BATCH)
    cmds = dict(vel=np.stack([vx, 0 * vx, 0 * vx], 1),
                gait_type=np.full(BATCH, 9, np.int32), robot_mode=np.zeros(BATCH, np.int32))
    f32 = {k: np.asarray(v, np.float32) for k, v in sensors.items()}
    return f32, {k: (v if v.dtype == np.int32 else v.astype(np.float32)) for k, v in cmds.items()}


def _jax_trees(sensors, cmds):
    return (JSensors(**{k: jnp.asarray(v) for k, v in sensors.items()}),
            JCommand(**{k: jnp.asarray(v) for k, v in cmds.items()}))


@pytest.fixture(scope="module")
def ticked():
    """JAX: three per-robot control ticks from init (the JAX test's state),
    then one control_tick_batched; the port's control_tick_batched from the
    same three-tick state. Returns (sensors, cmds, JAX state after 3 ticks,
    JAX (state, ctx) after the 4th, port (state, ctx) after the 4th)."""
    sensors, cmds = _inputs()
    js, jc = _jax_trees(sensors, cmds)

    def lane(s, c):
        state = j_ctrl.init_state(JCFG)
        for _ in range(3):
            state, ctx = j_ctrl.control_tick(JCFG, state, s, c)
        return state

    state3 = jax.jit(jax.vmap(lane))(js, jc)
    jstate, jctx = jax.jit(lambda st: j_ctrl.control_tick_batched(JCFG, st, js, jc))(state3)
    tstate, tctx = t_ctrl.control_tick_batched(
        CFG, port_state(state3), Sensors.from_numpy(sensors, device="cpu"),
        Command.from_numpy(cmds, device="cpu"))
    return sensors, cmds, state3, (jstate, jctx), (tstate, tctx)


@pytest.mark.parametrize("tree", ["state", "ctx"])
def test_control_tick_batched_matches_jax(ticked, tree):
    _, _, _, (jstate, jctx), (tstate, tctx) = ticked
    if tree == "state":
        assert_tree_close(tstate, jstate, 1e-5)
    else:
        assert_tree_close(tctx, jctx, 1e-5)


# (h_sol, max_stance): the uncompressed solve at the default horizon and
# the packed trot solve at h_sol=10
MPC_CASES = {"full": (None, None), "packed": (10, 2)}


@pytest.fixture(scope="module")
def solves(ticked):
    """For each MPC case, cold (120 iterations, zero warm triple) and warm
    (40 iterations from the cold solve's stored triple), JAX and port from
    the same JAX state: {(case, kind): (jax state, port state)}."""
    _, _, _, (jstate, jctx), _ = ticked
    tctx = port_ctx(jctx)
    out = {}
    for case, (h_sol, ms) in MPC_CASES.items():
        def jfn(st, it, h_sol=h_sol, ms=ms):
            return j_ctrl.mpc_update_batched(JCFG, st, jctx, h_sol=h_sol, iterations=it,
                                             max_stance=ms)

        jcold = jax.jit(lambda st: jfn(st, 120))(jstate)
        jwarm = jax.jit(lambda st: jfn(st, 40))(jcold)
        for kind, jin, jout, it in (("cold", jstate, jcold, 120), ("warm", jcold, jwarm, 40)):
            tout = t_ctrl.mpc_update_batched(CFG, port_state(jin), tctx, h_sol=h_sol,
                                             iterations=it, max_stance=ms)
            out[(case, kind)] = (jout, tout)
    return out


@pytest.mark.parametrize("kind", ["cold", "warm"])
@pytest.mark.parametrize("case", sorted(MPC_CASES))
def test_mpc_update_batched_matches_jax(solves, case, kind):
    jout, tout = solves[(case, kind)]
    jl, tl = jout.core.locomotion, tout.core.locomotion
    for name in ("fr_des", "f_ff"):
        got = getattr(tl, name).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(getattr(jl, name)), atol=0.15, err_msg=name)
    np.testing.assert_allclose(tl.world_position_desired.numpy(),
                               np.asarray(jl.world_position_desired), atol=1e-6)
    np.testing.assert_array_equal(tl.mpc_fail_count.numpy(), np.asarray(jl.mpc_fail_count))
    assert tl.mpc_fail_count.dtype == torch.int32
    for name in ("mpc_warm_x", "mpc_warm_z", "mpc_warm_y"):
        got = getattr(tl, name)
        assert got.shape == getattr(jl, name).shape
        assert torch.isfinite(got).all(), name
    assert tl.mpc_warm_x.abs().max() > 0            # a real iterate was stored
    # everything else of the state is the accept step's bookkeeping: exact
    # or at the control tick's tolerance
    rest = tout.replace(core=tout.core.replace(locomotion=tl.replace(
        fr_des=torch.as_tensor(np.array(jl.fr_des)), f_ff=torch.as_tensor(np.array(jl.f_ff)),
        mpc_warm_x=torch.as_tensor(np.array(jl.mpc_warm_x)),
        mpc_warm_z=torch.as_tensor(np.array(jl.mpc_warm_z)),
        mpc_warm_y=torch.as_tensor(np.array(jl.mpc_warm_y)))))
    assert_tree_close(rest, jout, 1e-5)


def test_packed_warm_store_is_full_layout(solves):
    """The packed path scatters its warm triple back to the (h_max, 4, d)
    layout: rows past h_sol are zero, as in JAX."""
    jout, tout = solves[("packed", "cold")]
    wx = tout.core.locomotion.mpc_warm_x
    assert wx.shape == (BATCH, CFG.mpc.h_max, 4, 3)
    assert (wx[:, 10:] == 0).all()
    assert (np.asarray(jout.core.locomotion.mpc_warm_x)[:, 10:] == 0).all()


def test_leg_commands_match_jax(ticked, solves):
    """leg_commands per lane after the cold full solve: tau and the rest of
    the output and the state, at the control tick's 1e-5."""
    _, _, _, (_, jctx), _ = ticked
    jstate = solves[("full", "cold")][0]
    jst, jout = jax.jit(jax.vmap(lambda s, c: j_ctrl.leg_commands(JCFG, s, c)))(jstate, jctx)
    tst, tout = vmap(lambda s, c: t_ctrl.leg_commands(CFG, s, c))(port_state(jstate),
                                                                  port_ctx(jctx))
    assert_tree_close(tout, jout, 1e-5)
    assert_tree_close(tst, jst, 1e-5)


# ---------------------------------------------------------------------------
# per-robot semantics (tests/test_safety_gate.py, tests/test_warm_start.py)

def _sensors(quat=(0.0, 0.0, 0.0, 1.0), q=None):
    q = np.tile([0.0, -0.8, 1.6], 4) if q is None else q
    return Sensors.from_numpy(dict(quat=np.asarray(quat, np.float32), gyro=np.zeros(3, np.float32),
                                   accelerometer=np.array([0.0, 0.0, 9.8], np.float32),
                                   q=np.asarray(q, np.float32), qd=np.zeros(12, np.float32)),
                              device="cpu")


def _ticked(sensors=None, state=None):
    state = t_ctrl.init_state(CFG, device="cpu") if state is None else state
    cmd = Command.create(0.3, 0.0, 0.0, gait_type=9, device="cpu")
    return t_ctrl.control_tick(CFG, state, sensors or _sensors(), cmd)


def _roll(angle):
    return (np.sin(angle), 0.0, 0.0, np.cos(angle))


def _trip(kind):
    """(state after leg_commands, output) with one safety check tripped."""
    if kind == "orientation":            # ~0.6 rad roll > 0.5 rad
        state, ctx = _ticked(_sensors(quat=_roll(0.3)))
        assert not bool(state.core.safety_ok)
    elif kind == "joint_limit":          # abad beyond +-60 deg
        q = np.tile([0.0, -0.8, 1.6], 4)
        q[0] = 2.0
        state, ctx = _ticked(_sensors(q=q))
        assert not bool(state.core.safety_ok)
    elif kind == "p_des_foot":           # commanded foot 10 m away
        state, ctx = _ticked()
        state = state.replace(swing_p_cur=torch.full((4, 3), 10.0))
    elif kind == "force_feedforward":    # beyond the +-350 N box
        state, ctx = _ticked()
        loco = state.core.locomotion.replace(f_ff=torch.full((4, 3), 1000.0))
        state = state.replace(core=state.core.replace(locomotion=loco))
    else:                                # latch: trip, then nominal again
        state, _ = _ticked(_sensors(quat=_roll(0.3)))
        state, ctx = _ticked(state=state)
    return t_ctrl.leg_commands(CFG, state, ctx)


def test_nominal_tick_keeps_safety_ok():
    state, ctx = _ticked()
    state, out = t_ctrl.leg_commands(CFG, state, ctx)
    assert bool(state.core.safety_ok)
    assert bool((out.tau != 0.0).any())


@pytest.mark.parametrize("kind", ["orientation", "joint_limit", "p_des_foot",
                                  "force_feedforward", "latch"])
def test_safety_trips(kind):
    state, out = _trip(kind)
    assert not bool(state.core.safety_ok)
    assert bool((out.tau == 0.0).all())


def test_solution_ok_rejects_infeasible_and_nonfinite():
    h = CFG.mpc.h_max
    table = torch.ones((h, 4))
    good = torch.zeros((h, 4, 3))
    good[..., 2] = 20.0
    assert bool(t_ctrl.solution_ok(CFG, good, table))
    over = good.clone()
    over[..., 2] = CFG.mpc.f_max + 10.0
    assert not bool(t_ctrl.solution_ok(CFG, over, table))
    swing_tbl = table.clone()
    swing_tbl[:, 0] = 0.0
    assert not bool(t_ctrl.solution_ok(CFG, good, swing_tbl))
    nan = good.clone()
    nan[0, 0, 0] = float("nan")
    assert not bool(t_ctrl.solution_ok(CFG, nan, table))
    for f, t in ((good, table), (over, table), (good, swing_tbl), (nan, table)):
        assert bool(t_ctrl.solution_ok(CFG, f, t)) == bool(
            j_ctrl.solution_ok(JCFG, jnp.asarray(f.numpy()), jnp.asarray(t.numpy())))


def test_solver_failure_holds_previous_solution():
    state, ctx = _ticked()
    known = torch.zeros((4, 3))
    known[:, 2] = 22.5
    state = state.replace(core=state.core.replace(
        locomotion=state.core.locomotion.replace(fr_des=known)))
    bad_ctx = dict(ctx, p_foot=torch.full((4, 3), float("nan")))
    out = t_ctrl.mpc_update(CFG, state, bad_ctx, iterations=8)
    loco = out.core.locomotion
    assert torch.equal(loco.fr_des, known)
    assert int(loco.mpc_fail_count) == 1
    assert (loco.mpc_warm_x == 0).all() and (loco.mpc_warm_y == 0).all()


def test_mpc_update_picks_warm_against_cold():
    """With iterations=None the per-robot mpc_update runs the cold budget
    from a zero warm triple and the warm budget from a live one, exactly as
    the explicit budgets do, and agrees with the JAX mpc_update."""
    state, ctx = _ticked()
    cold = t_ctrl.mpc_update(CFG, state, ctx)
    cold_explicit = t_ctrl.mpc_update(CFG, state, ctx, iterations=CFG.solver.iterations)
    assert torch.equal(cold.core.locomotion.fr_des, cold_explicit.core.locomotion.fr_des)
    assert cold.core.locomotion.mpc_warm_x.abs().max() > 0
    warm = t_ctrl.mpc_update(CFG, cold, ctx)
    warm_explicit = t_ctrl.mpc_update(CFG, cold, ctx, iterations=CFG.solver.warm_iterations)
    assert torch.equal(warm.core.locomotion.fr_des, warm_explicit.core.locomotion.fr_des)
    assert not torch.equal(warm.core.locomotion.fr_des,
                           t_ctrl.mpc_update(CFG, cold, ctx,
                                             iterations=CFG.solver.iterations
                                             ).core.locomotion.fr_des)
    assert int(warm.core.locomotion.mpc_fail_count) == 0

    jstate, jctx = j_ctrl.control_tick(
        JCFG, j_ctrl.init_state(JCFG),
        JSensors(**{k: jnp.asarray(v) for k, v in _sensors().to_numpy().items()}),
        JCommand.create(0.3, 0.0, 0.0, gait_type=9))
    jcold = j_ctrl.mpc_update(JCFG, jstate, jctx)
    jwarm = j_ctrl.mpc_update(JCFG, jcold, jctx)
    for t, j in ((cold, jcold), (warm, jwarm)):
        np.testing.assert_allclose(t.core.locomotion.fr_des.numpy(),
                                   np.asarray(j.core.locomotion.fr_des), atol=0.15)


def test_zero_warm_is_cold_start():
    rng = np.random.default_rng(SEED)
    h, b = 10, 4
    m = rng.standard_normal((b, 120, 120)).astype(np.float32)
    hess = torch.as_tensor(m @ m.transpose(0, 2, 1) * 1e-6 + np.eye(120, dtype=np.float32) * 1e-4)
    grad = torch.as_tensor(rng.standard_normal((b, 120)).astype(np.float32) * 1e-2)
    gait = torch.ones((b, h, 4))
    zeros = (torch.zeros((b, 120)), torch.zeros((b, 200)), torch.zeros((b, 200)))
    a = t_admm.admm_mpc_batched(CFG.solver, CFG.mpc, hess, grad, gait, iterations=60)
    bw = t_admm.admm_mpc_batched(CFG.solver, CFG.mpc, hess, grad, gait, iterations=60,
                                 warm=zeros)
    assert torch.equal(a, bw)


def test_mpc_update_batched_warm_and_failure(ticked):
    """A second solve from the stored warm triple keeps the fail counter at
    zero; a poisoned problem counts one failure and resets the store."""
    _, _, _, (jstate, jctx), _ = ticked
    state, ctx = port_state(jstate), port_ctx(jctx)
    out = t_ctrl.mpc_update_batched(CFG, state, ctx, h_sol=10, iterations=60, max_stance=2)
    out2 = t_ctrl.mpc_update_batched(CFG, out, ctx, h_sol=10, iterations=40, max_stance=2)
    assert int(out2.core.locomotion.mpc_fail_count.max()) == 0
    assert torch.isfinite(out2.core.locomotion.fr_des).all()
    bad = dict(ctx, p_foot=torch.full((BATCH, 4, 3), float("nan")))
    fail = t_ctrl.mpc_update_batched(CFG, out, bad, h_sol=10, iterations=8, max_stance=2)
    assert int(fail.core.locomotion.mpc_fail_count.min()) == 1
    assert (fail.core.locomotion.mpc_warm_x == 0).all()
    assert (fail.core.locomotion.mpc_warm_y == 0).all()
    assert torch.equal(fail.core.locomotion.fr_des, out.core.locomotion.fr_des)
