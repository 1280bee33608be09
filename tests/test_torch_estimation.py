"""The port's estimators against the JAX package on the CPU: the orientation
estimator, the per-robot Kalman filter `linear_kf.run` and the batch-explicit
`linear_kf.run_batched`, over 20 ticks at batch 8, at the JAX package's own
tolerance for the filter (2e-4, tests/test_estimation.py). Inputs are drawn
with numpy (seed 3, the JAX test's) and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.core.types import EstimatorState as JEstimatorState
from quadruped_ctrl_tpu.core.types import Sensors as JSensors
from quadruped_ctrl_tpu.estimation import linear_kf as j_kf
from quadruped_ctrl_tpu.estimation import orientation as j_ori
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.core.types import EstimatorState, Sensors, vmap
from quadruped_ctrl_tpu_torch.estimation import linear_kf as t_kf
from quadruped_ctrl_tpu_torch.estimation import orientation as t_ori
from tests.test_torch_package import _one_thread  # noqa: F401

CFG, JCFG = default_config(), jax_default_config()
B, TICKS = 8, 20


def _rotz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _kf_inputs(initial_p: float):
    """The JAX filter test's inputs (tests/test_estimation.py:100-150) at
    batch B: xhat, P, then the per-tick measurements held fixed."""
    rng = np.random.default_rng(3)
    xhat = (rng.standard_normal((B, 18)) * 0.1).astype(np.float32)
    xhat[:, 2] += 0.28
    p_cov = np.tile(np.eye(18, dtype=np.float32)[None] * initial_p, (B, 1, 1))
    a_world = (rng.standard_normal((B, 3)) * 0.5 + [0.0, 0.0, 9.81]).astype(np.float32)
    r_body = np.stack([_rotz(t) for t in rng.standard_normal(B) * 0.3])
    omega = (rng.standard_normal((B, 3)) * 0.2).astype(np.float32)
    leg_p = rng.uniform(-0.3, -0.1, (B, 4, 3)).astype(np.float32)
    leg_v = (rng.standard_normal((B, 4, 3)) * 0.1).astype(np.float32)
    phase = rng.uniform(0, 1, (B, 4)).astype(np.float32)
    return xhat, p_cov, (a_world, r_body, omega, leg_p, leg_v, phase)


def _jax_run(hips):
    return jax.jit(jax.vmap(lambda x, P, a, r, o, lp, lv, cp: j_kf.run(
        JCFG.estimator, x, P, a, r, o, hips, lp, lv, cp)[:2]))


def _jax_run_batched(hips):
    return jax.jit(lambda x, P, a, r, o, lp, lv, cp: j_kf.run_batched(
        JCFG.estimator, x, P, a, r, o, hips, lp, lv, cp)[:2])


@pytest.fixture(scope="module")
def kf_traces():
    """(JAX run, JAX run_batched, port run, port run_batched) over TICKS
    ticks from P = I: a list per filter of (xhat, P) after each tick."""
    xhat, p_cov, meas = _kf_inputs(1.0)
    hips_np = JCFG.robot.hip_locations()
    hips_t = torch.as_tensor(hips_np)
    meas_t = [torch.as_tensor(m) for m in meas]
    jfns = (_jax_run(jnp.asarray(hips_np)), _jax_run_batched(jnp.asarray(hips_np)))

    def t_run(x, p):
        return vmap(lambda x_, p_, a, r, o, lp, lv, cp: t_kf.run(
            CFG.estimator, x_, p_, a, r, o, hips_t, lp, lv, cp)[:2])(x, p, *meas_t)

    def t_run_batched(x, p):
        return t_kf.run_batched(CFG.estimator, x, p, *meas_t[:3], hips_t, *meas_t[3:])[:2]

    traces = []
    for fn in jfns:
        x, p, out = jnp.asarray(xhat), jnp.asarray(p_cov), []
        for _ in range(TICKS):
            x, p = fn(x, p, *(jnp.asarray(m) for m in meas))
            out.append((np.asarray(x), np.asarray(p)))
        traces.append(out)
    for fn in (t_run, t_run_batched):
        x, p, out = torch.as_tensor(xhat), torch.as_tensor(p_cov), []
        for _ in range(TICKS):
            x, p = fn(x, p)
            out.append((x.numpy(), p.numpy()))
        traces.append(out)
    return traces


@pytest.mark.parametrize("pair", ["run", "run_batched", "run_batched_vs_own_run"])
def test_kf_matches(kf_traces, pair):
    """Port `run` against JAX `run`, port `run_batched` against JAX
    `run_batched`, and the port's `run_batched` against its own `run`,
    tick by tick, at 2e-4."""
    j_run, j_batched, t_run, t_batched = kf_traces
    a, b = {"run": (t_run, j_run), "run_batched": (t_batched, j_batched),
            "run_batched_vs_own_run": (t_batched, t_run)}[pair]
    for tick, ((xa, pa), (xb, pb)) in enumerate(zip(a, b)):
        assert np.isfinite(xa).all() and np.isfinite(pa).all()
        np.testing.assert_allclose(xa, xb, atol=2e-4, err_msg=f"xhat at tick {tick}")
        np.testing.assert_allclose(pa, pb, atol=2e-4, err_msg=f"P at tick {tick}")


def test_kf_batched_through_the_initial_transient():
    """From the initial_p=100 covariance the Joseph-form filter stays finite
    with positive variances, and equals the JAX one."""
    xhat, p_cov, meas = _kf_inputs(100.0)
    hips_np = JCFG.robot.hip_locations()
    fn = _jax_run_batched(jnp.asarray(hips_np))
    jx, jp = jnp.asarray(xhat), jnp.asarray(p_cov)
    tx, tp = torch.as_tensor(xhat), torch.as_tensor(p_cov)
    meas_t = [torch.as_tensor(m) for m in meas]
    for _ in range(6):
        jx, jp = fn(jx, jp, *(jnp.asarray(m) for m in meas))
        tx, tp = t_kf.run_batched(CFG.estimator, tx, tp, *meas_t[:3],
                                  torch.as_tensor(hips_np), *meas_t[3:])[:2]
        assert torch.isfinite(tp).all()
        assert (torch.diagonal(tp, dim1=1, dim2=2) > 0).all()
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=2e-4)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-4)


@pytest.mark.parametrize("first_visit", [True, False])
def test_orientation_matches_jax(first_visit):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    sensors = dict(quat=q, gyro=rng.uniform(-1, 1, (B, 3)),
                   accelerometer=rng.uniform(-1, 1, (B, 3)) + [0, 0, 9.8],
                   q=rng.uniform(-1, 1, (B, 12)), qd=rng.uniform(-1, 1, (B, 12)))
    sensors = {k: np.asarray(v, np.float32) for k, v in sensors.items()}
    est = JEstimatorState.create()
    ini = rng.standard_normal(4).astype(np.float32)
    est = est.replace(first_visit=jnp.asarray(first_visit),
                      ori_ini_inv=jnp.asarray(ini / np.linalg.norm(ini)))
    jest = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), est)
    jnew, jout = jax.jit(jax.vmap(j_ori.run))(
        jest, JSensors(**{k: jnp.asarray(v) for k, v in sensors.items()}))
    test = EstimatorState.from_numpy(jax.tree.map(np.asarray, jest.__dict__), device="cpu")
    tnew, tout = vmap(t_ori.run)(test, Sensors.from_numpy(sensors, device="cpu"))
    for k, v in jout.items():
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(v), atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tnew.ori_ini_inv.numpy(), np.asarray(jnew.ori_ini_inv),
                               atol=1e-6)
    assert not tnew.first_visit.any()
    assert tnew.first_visit.dtype == torch.bool
