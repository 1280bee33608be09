"""PyTorch port vs JAX package: the per-scenario MPC solve on the CPU, with
the same numpy inputs fed to both.

Covered: the per-scenario formation (`srb_ct_dynamics`, `expm_fixed`,
`discretize`, `discretize_expm`, `condense`, `qp_cost`, `qp_cost_nil`,
`compress_stance`, `qp_cost_compressed`, `qp_cost_compressed_nil`,
`scatter_forces`), the guarded warm start of `_ns_inverse`, `admm_mpc`,
`admm_dense`, `kkt_residuals`, the pipeline's `solve_batch` and
`solve_compressed_batch` (torch.func.vmap over the per-scenario solves), and
the port's own `solver/problem_generator.py` and float64 `solver/ipm.py`.

Tolerances are the JAX tests' for the same comparisons: 1e-5 relative for
the formation; 0.15 N between fp32 solves that compute the same thing;
0.5 N (test_admm.py) and 0.7 N (test_pipeline.py) against the float64
oracle of tests/oracle.py; 3e-3 and 5e-3 x scale for admm_dense against the
IPM (test_admm.py, test_problem_generator.py).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.mpc import formation as JF
from quadruped_ctrl_tpu.mpc import pipeline as JP
from quadruped_ctrl_tpu.solver import admm as JA
from quadruped_ctrl_tpu.solver import ipm as JIPM
from quadruped_ctrl_tpu.solver import problem_generator as JPG
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.mpc import formation as TF
from quadruped_ctrl_tpu_torch.mpc import pipeline as TP
from quadruped_ctrl_tpu_torch.solver import admm as TA
from quadruped_ctrl_tpu_torch.solver import ipm as TIPM
from quadruped_ctrl_tpu_torch.solver import problem_generator as TPG
from tests import oracle
from tests.test_admm import _mpc_qp
from tests.test_pipeline import _oracle_forces
from tests.test_torch_ns_inverse import _spd_batch
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)

JCFG = jax_default_config()
CFG = default_config()


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(t, j, rtol=1e-5):
    """Port tensor t against JAX array j to rtol of j's largest entry."""
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=rtol * max(np.abs(j).max(), 1e-30))


def _scenario(seed: int, h: int = 6):
    """One scenario of the port's random_inputs as numpy arrays (batch axis
    dropped)."""
    return {k: v[0] for k, v in TP.random_inputs(seed, 1, h, device="cpu").to_numpy().items()}


def _dynamics(inp):
    """(a_ct, b_ct, adt, bdt, x0) of both packages for one scenario."""
    m = CFG.mpc
    a_j, b_j = JF.srb_ct_dynamics(JCFG.mpc, inp["r_feet"], inp["rpy"][2], inp["x_drag"])
    a_t, b_t = TF.srb_ct_dynamics(m, _t(inp["r_feet"]), _t(inp["rpy"][2]), _t(inp["x_drag"]))
    adt_j, bdt_j = JF.discretize(a_j, b_j, JCFG.dt_mpc)
    adt_t, bdt_t = TF.discretize(a_t, b_t, CFG.dt_mpc)
    x0 = np.asarray(JF.build_x0(inp["rpy"], inp["position"], inp["omega_world"],
                                inp["v_world"], JCFG.mpc.gravity))
    return (a_t, b_t, adt_t, bdt_t), (a_j, b_j, adt_j, bdt_j), x0


@pytest.mark.parametrize("seed", [0, 1])
def test_dynamics_and_discretization_match_jax(seed):
    inp = _scenario(seed)
    inp["x_drag"] = np.float32(0.3 * seed)          # the drag entry too
    port, ref, _ = _dynamics(inp)
    for t, j in zip(port, ref):
        _close(t, j)
    a_t, b_t, adt_t, bdt_t = port
    # the closed form against the generic augmented exponential, both packages
    e_t = TF.discretize_expm(a_t, b_t, CFG.dt_mpc)
    e_j = JF.discretize_expm(ref[0], ref[1], JCFG.dt_mpc)
    for t, j in zip(e_t, e_j):
        _close(t, j)
    _close(adt_t, e_t[0].numpy())
    _close(bdt_t, e_t[1].numpy())
    m = np.random.default_rng(seed).normal(size=(3, 7, 7)).astype(np.float32) * 0.3
    _close(TF.expm_fixed(_t(m)), JF.expm_fixed(jnp.asarray(m)))


def test_condensed_costs_match_jax():
    """condense, qp_cost and the closed-form qp_cost_nil, _ax0_closed, with
    the last two steps masked out."""
    h = 6
    inp = _scenario(2, h)
    (_, _, adt_t, bdt_t), (_, _, adt_j, bdt_j), x0 = _dynamics(inp)
    mask = np.ones(h, np.float32)
    mask[-2:] = 0.0
    aq_t, bq_t = TF.condense(adt_t, bdt_t, h)
    aq_j, bq_j = JF.condense(adt_j, bdt_j, h)
    _close(aq_t, aq_j)
    _close(bq_t, bq_j)
    args_j = (x0, inp["traj"], mask)
    args_t = tuple(map(_t, args_j))
    for t, j in zip(TF.qp_cost(CFG.mpc, aq_t, bq_t, *args_t),
                    JF.qp_cost(JCFG.mpc, aq_j, bq_j, *args_j)):
        _close(t, j)
    for t, j in zip(TF.qp_cost_nil(CFG.mpc, adt_t, bdt_t, *args_t),
                    JF.qp_cost_nil(JCFG.mpc, adt_j, bdt_j, *args_j)):
        _close(t, j)
    n1, n2, _ = TF._nil_family(adt_t, bdt_t)
    jn1, jn2, _ = JF._nil_family(adt_j, bdt_j)
    _close(TF._ax0_closed(n1, n2, _t(x0), h), JF._ax0_closed(jn1, jn2, x0, h))


def test_stance_compression_matches_jax():
    """compress_stance on ties (all-swing and all-stance steps, where the
    stable argsort keeps foot order), the compressed costs at max_stance 2
    and 3, and the unbatched scatter_forces."""
    h = 6
    inp = _scenario(3, h)
    gait = np.array([[1, 0, 0, 1], [0, 0, 0, 0], [1, 1, 1, 1], [0, 1, 1, 0], [0, 1, 0, 0],
                     [1, 1, 0, 1]], np.float32)
    (_, _, adt_t, bdt_t), (_, _, adt_j, bdt_j), x0 = _dynamics(inp)
    aq_t, bq_t = TF.condense(adt_t, bdt_t, h)
    aq_j, bq_j = JF.condense(adt_j, bdt_j, h)
    args_j = (x0, inp["traj"], np.ones(h, np.float32))
    args_t = tuple(map(_t, args_j))
    for ms in (2, 3):
        fi_t, gr_t = TF.compress_stance(_t(gait), ms)
        fi_j, gr_j = JF.compress_stance(jnp.asarray(gait), ms)
        assert fi_t.dtype == torch.int32
        np.testing.assert_array_equal(fi_t.numpy(), np.asarray(fi_j))
        np.testing.assert_array_equal(gr_t.numpy(), np.asarray(gr_j))
        for t, j in zip(TF.qp_cost_compressed(CFG.mpc, aq_t, bq_t, *args_t, fi_t),
                        JF.qp_cost_compressed(JCFG.mpc, aq_j, bq_j, *args_j, fi_j)):
            _close(t, j)
        for t, j in zip(TF.qp_cost_compressed_nil(CFG.mpc, adt_t, bdt_t, *args_t, fi_t),
                        JF.qp_cost_compressed_nil(JCFG.mpc, adt_j, bdt_j, *args_j, fi_j)):
            _close(t, j)
        x_red = np.random.default_rng(ms).normal(size=h * ms * 3).astype(np.float32)
        np.testing.assert_array_equal(TF.scatter_forces(_t(x_red), fi_t, h).numpy(),
                                      np.asarray(JF.scatter_forces(x_red, fi_j, h)))
    np.testing.assert_array_equal(np.asarray(JF.compress_stance(jnp.asarray(gait), 2)[0])[1],
                                  [0, 1])                     # all swing: foot order


def test_guarded_ns_inverse_matches_jax():
    """_ns_inverse(init=): a good start (the inverse of a nearby matrix)
    passes the 0.9 guard and a garbage one falls back to the cold start;
    against the JAX function per matrix to 1e-4 of max |inv|, with leading
    dims (2, 3)."""
    s = CFG.solver
    ks = _spd_batch(4, 6, 24, 24, 1e2)
    near = (ks * np.float32(1.002)).astype(np.float32)
    good = np.linalg.inv(near.astype(np.float64)).astype(np.float32)
    init = np.concatenate([good[:3], np.full_like(good[3:], 17.0)])
    x_t = TA._ns_inverse(_t(ks).reshape(2, 3, 24, 24), 4, _t(init).reshape(2, 3, 24, 24))
    x_j = np.asarray(jax.vmap(lambda m, i: JA._ns_inverse(m, 4, init=i))(ks, init))
    _close(x_t.reshape(6, 24, 24), x_j, rtol=1e-4)
    resid = np.abs(np.eye(24) - ks.astype(np.float64) @ x_j).sum(-1).max(-1)
    assert (resid[:3] < 1e-3).all() and (resid[3:] > 1e-3).all()      # 4 steps: warm only
    cold = TA._ns_inverse(_t(ks), s.ns_iters)
    np.testing.assert_array_equal(TA._ns_inverse(_t(ks[3:]), s.ns_iters, _t(init[3:])).numpy(),
                                  cold[3:].numpy())


_jax_admm_mpc = jax.jit(lambda hh, gg, gt: JA.admm_mpc(JCFG.solver, JCFG.mpc, hh, gg, gt))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_admm_mpc_matches_jax_and_oracle(seed):
    """admm_mpc on test_admm.py's problems (h = 4), against the JAX function
    under jit (gate 0.15 N; measured 0.013-0.062 N) and, on the first
    step's forces, the float64 oracle (gate 0.5 N; measured 0.007-0.049 N,
    the JAX function 0.003-0.009 N), with the JAX test's primal feasibility
    (< 0.1 N)."""
    h = 4
    hess, grad, fmat, l, u, gait = _mpc_qp(np.random.default_rng(seed), h)
    x_t = TA.admm_mpc(CFG.solver, CFG.mpc, _t(hess), _t(grad), _t(gait)).double().numpy()
    x_j = np.asarray(_jax_admm_mpc(*(jnp.asarray(a, jnp.float32) for a in (hess, grad, gait))))
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=0.15)
    x_true = oracle.solve_mpc_qp_exact(hess, grad, gait, CFG.mpc.mu, CFG.mpc.f_max)
    np.testing.assert_allclose(x_t[:12], x_true[:12], atol=0.5)
    ax = fmat @ x_t
    assert max(0.0, (ax - u).max(), (l - ax).max()) < 0.1


def test_admm_mpc_warm_contract():
    """Zeros as `warm` are exactly the cold start; `return_warm` gives the
    pre-polish iterate in normalized units (n = 48, m = 80), which
    warm-starts a shorter solve to within 0.5 N of the cold one."""
    hess, grad, _, _, _, gait = _mpc_qp(np.random.default_rng(2), 4)
    args = (CFG.solver, CFG.mpc, _t(hess), _t(grad), _t(gait))
    cold, (wx, wz, wy) = TA.admm_mpc(*args, return_warm=True)
    assert wx.shape == (48,) and wz.shape == (80,) and wy.shape == (80,)
    assert torch.equal(TA.admm_mpc(*args, warm=(torch.zeros(48), torch.zeros(80),
                                                torch.zeros(80))), cold)
    warm = TA.admm_mpc(*args, warm=(wx, wz, wy), iterations=40)
    assert torch.isfinite(warm).all()
    np.testing.assert_allclose(warm.numpy(), cold.numpy(), rtol=0, atol=0.5)


def _dense_qp():
    """test_admm.py::test_admm_dense_well_scaled_qp's problem."""
    rng = np.random.default_rng(10)
    n, m = 24, 30
    mroot = rng.normal(size=(n, n))
    hess = mroot @ mroot.T / n + 0.5 * np.eye(n)
    grad = rng.normal(size=n)
    a_mat = rng.normal(size=(m, n)) / np.sqrt(n)
    return hess, grad, a_mat, -rng.uniform(0.5, 1.5, m), rng.uniform(0.5, 1.5, m)


def test_admm_dense_matches_ipm():
    """admm_dense (200 iterations, 4 polish rounds) on the well-scaled QP of
    test_admm.py against the port's float64 IPM (gate 3e-3; measured
    1.5e-3), which equals the JAX package's numpy IPM to 1e-10; the KKT
    residuals of the port's solution equal the JAX function's on it."""
    qp = _dense_qp()
    x_true = TIPM.solve_qp_exact(*qp)
    np.testing.assert_allclose(x_true.numpy(), JIPM.solve_qp_exact(*qp), rtol=0, atol=1e-10)
    x, z, y = TA.admm_dense(CFG.solver, *map(_t, qp), iterations=200, polish_rounds=4)
    np.testing.assert_allclose(x.numpy(), x_true.numpy(), atol=3e-3)
    hess, grad, a_mat, l, u = map(np.float32, qp)
    res_t = TA.kkt_residuals(*map(_t, (hess, grad, a_mat, l, u)), x, y)
    res_j = JA.kkt_residuals(hess, grad, a_mat, l, u, x.numpy(), y.numpy())
    for t, j in zip(res_t, res_j):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5, atol=1e-6)


def test_generated_problems_admm_dense_matches_ipm():
    """test_problem_generator.py's case: three random controllable MPC QPs
    from the port's generator (equal to the JAX package's for the same
    Generator state), admm_dense (200 iterations, 6 polish rounds) against
    the port's IPM, gate 5e-3 x max(1, |x|) (measured <= 8.5e-6)."""
    rng_t, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        qp = TPG.random_mpc_qp(rng_t, n_states=8, n_controls=6, horizon=5)
        for a, b in zip(qp, JPG.random_mpc_qp(rng_j, n_states=8, n_controls=6, horizon=5)):
            np.testing.assert_array_equal(a, b)
        x_true = TIPM.solve_qp_exact(*qp).numpy()
        x, _, _ = TA.admm_dense(CFG.solver, *map(_t, qp), iterations=200, polish_rounds=6)
        scale = max(1.0, np.abs(x_true).max())
        np.testing.assert_allclose(x.numpy(), x_true, atol=5e-3 * scale)


def test_ipm_certificate_raises():
    """Stopped short of convergence (2 iterations), the IPM fails its KKT
    certificate and raises, as the JAX package's does."""
    qp = _dense_qp()
    with pytest.raises(AssertionError, match="KKT"):
        TIPM.solve_qp_exact(*qp, iters=2)
    with pytest.raises(AssertionError, match="KKT"):
        JIPM.solve_qp_exact(*qp, iters=2)


PIPE_SEED, PIPE_B, PIPE_H = 0, 4, 6


@pytest.fixture(scope="module")
def pipe_inputs():
    return TP.random_inputs(PIPE_SEED, PIPE_B, PIPE_H, device="cpu")


@pytest.mark.parametrize("compressed", [False, True])
def test_pipeline_batch_solves_match_jax_and_oracle(pipe_inputs, compressed):
    """solve_batch (n = 72) and solve_compressed_batch (max_stance 2,
    n = 36) on the port's random_inputs(seed 0, batch 4, h 6), against the
    JAX functions under jit (gate 0.15 N; measured 0.049 N and 0.075 N) and,
    on the step-0 forces, test_pipeline.py's float64 oracle (gate 0.7 N;
    measured 0.028 N and 0.016 N); the dropped swing feet carry exactly 0.
    Seeds 1, 2, 4 and 7 land 0.15-0.20 N from JAX on one path or the other
    (the reference's knife edges, ROADMAP queue 3)."""
    inp = JP.MPCInputs(**{k: jnp.asarray(v) for k, v in pipe_inputs.to_numpy().items()})
    if compressed:
        f_t = TP.solve_compressed_batch(CFG, pipe_inputs, 2).numpy()
        f_j = np.asarray(jax.jit(lambda i: JP.solve_compressed_batch(JCFG, i, 2))(inp))
        assert (f_t[pipe_inputs.gait_table.numpy() == 0] == 0).all()
    else:
        f_t = TP.solve_batch(CFG, pipe_inputs).numpy()
        f_j = np.asarray(jax.jit(lambda i: JP.solve_batch(JCFG, i))(inp))
    assert f_t.shape == (PIPE_B, PIPE_H, 4, 3) and np.isfinite(f_t).all()
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=0.15)
    arrays = pipe_inputs.to_numpy()
    for b in range(PIPE_B):
        want = _oracle_forces(types.SimpleNamespace(**{k: v[b] for k, v in arrays.items()}))
        np.testing.assert_allclose(f_t[b, 0], want[0], atol=0.7)


def test_pipeline_single_solve_equals_batch_row(pipe_inputs):
    """solve on one scenario against row 0 of solve_batch: within 0.1 N,
    test_admm.py::test_vmapped_batch_solve's gate for the same pair in JAX
    (batched and single products round differently and the polish's active
    set decisions amplify it; measured 0.044 N)."""
    one = TP.MPCInputs(**{k: v[0] for k, v in vars(pipe_inputs).items()})
    f_one = TP.solve(CFG, one, iterations=30, polish_rounds=1)
    f_all = TP.solve_batch(CFG, pipe_inputs, iterations=30, polish_rounds=1)
    assert f_one.shape == (PIPE_H, 4, 3)
    np.testing.assert_allclose(f_one.numpy(), f_all[0].numpy(), rtol=0, atol=0.1)
