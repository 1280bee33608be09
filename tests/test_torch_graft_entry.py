"""The port's graft entry points (`graft_entry.py`) on the CPU against the JAX
package: `entry()`'s controller step against the JAX `controller_step` from
the same state, and `dryrun_multichip`'s all-reduced mean |tau| over one
batched scenario step, at one rank and over a two-rank Gloo group, against
the same step in JAX (`__graft_entry__.dryrun_multichip`'s body, unsharded:
every scenario starts identical, so the mean does not depend on the
split)."""

import jax
import jax.numpy as jnp
import numpy as np

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.control import controller as jctrl
from quadruped_ctrl_tpu.core.types import Command as JCommand
from quadruped_ctrl_tpu.sim import engine as jengine
from quadruped_ctrl_tpu.sim.terrain import Terrain as JTerrain
from quadruped_ctrl_tpu_torch import graft_entry
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


def test_entry_step_matches_jax():
    """One controller step from the initial state (an MPC tick: the first
    tick solves) against the JAX step; torques within 1e-3 N m."""
    fn, args = graft_entry.entry(device="cpu")
    state, tau = fn(*args)
    assert tau.shape == (12,) and tau.device.type == "cpu"
    jcfg = jax_default_config()
    jstate = jctrl.init_state(jcfg)
    jsensors = jengine.sensors_from_sim(jcfg, jengine.sim_init(jcfg, JTerrain.plane()))
    jcmd = JCommand.create(0.3, 0.0, 0.0, gait_type=9, robot_mode=0)
    _, jout = jax.jit(lambda s, sn, c: jctrl.controller_step(jcfg, s, sn, c))(
        jstate, jsensors, jcmd)
    np.testing.assert_allclose(tau.numpy(), np.asarray(jout.tau), atol=1e-3)


def _jax_mean_tau(batch: int = 2) -> float:
    cfg = jax_default_config(**{"mpc.h_max": 10})
    states, sims = jax.vmap(lambda _: (jctrl.init_state(cfg),
                                       jengine.sim_init(cfg, JTerrain.plane())))(
        jnp.arange(batch))
    cmds = jax.vmap(lambda _: JCommand.create(0.3, 0.0, 0.0, 9, 0))(jnp.arange(batch))

    def step(states, sims, cmds):
        sensors = jax.vmap(lambda s: jengine.sensors_from_sim(cfg, s))(sims)
        states, ctx = jax.vmap(lambda st, sn, c: jctrl.control_tick(cfg, st, sn, c))(
            states, sensors, cmds)
        states = jctrl.mpc_update_batched(cfg, states, ctx)
        _, outs = jax.vmap(lambda st, c: jctrl.leg_commands(cfg, st, c))(states, ctx)
        return jnp.mean(jnp.abs(outs.tau))

    return float(jax.jit(step)(states, sims, cmds))


def test_dryrun_multichip_matches_jax():
    """Measured: 2.3151934 (port) against 2.3151937 (JAX)."""
    want = _jax_mean_tau()
    one = graft_entry.dryrun_multichip(1, device="cpu")
    two = graft_entry.dryrun_multichip(2, device="cpu")
    assert np.isfinite(one) and np.isfinite(two)
    np.testing.assert_allclose(one, want, rtol=1e-4)
    np.testing.assert_allclose(two, want, rtol=1e-4)
