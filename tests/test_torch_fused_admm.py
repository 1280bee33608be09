"""PyTorch port vs JAX package: the single-launch solve K5
(`ops/fused_admm.fused_admm_solve`) and the path that runs it,
`solve_packed_batch(use_fused=True)`, on the CPU with the same numpy inputs
fed to both. The JAX kernel runs in Pallas interpret mode, as
test_pallas_kernels.py runs it.

Tolerance: 0.5 N, the JAX kernel test's own (test_pallas_kernels.py:
test_fused_admm_kernel_interpret). The ADMM phase alone agrees to ~1e-6
relative; the polish rounds invert K with w_act = 1e4 on the active set (cond
~1e5), where fp32 NS inverses of two summation orders differ by ~1e-3
relative, and the forces by up to ~0.2 N (measured margins in each test).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.mpc import formation as JF
from quadruped_ctrl_tpu.mpc import pipeline as JP
from quadruped_ctrl_tpu.ops import fused_admm as JFA
from quadruped_ctrl_tpu.solver import admm as JA
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.mpc import formation as TF
from quadruped_ctrl_tpu_torch.mpc import pipeline as TP
from quadruped_ctrl_tpu_torch.ops import fused_admm as FA
from quadruped_ctrl_tpu_torch.solver import admm as TA
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


JCFG = jax_default_config()     # drives the JAX side
CFG = default_config()          # the port's own


def _kernel_operands(h: int = 4, b: int = FA.G):
    """The padded operands of test_pallas_kernels.test_fused_admm_kernel_interpret
    (per-scenario uncompressed QPs from random_inputs(PRNGKey(3))), as numpy."""
    inputs = JP.random_inputs(jax.random.PRNGKey(3), b, h)

    def form(inp):
        a_ct, b_ct = JF.srb_ct_dynamics(JCFG.mpc, inp.r_feet, inp.rpy[2], inp.x_drag)
        adt, bdt = JF.discretize(a_ct, b_ct, JCFG.dt_mpc)
        x0 = JF.build_x0(inp.rpy, inp.position, inp.omega_world, inp.v_world,
                         JCFG.mpc.gravity)
        return JF.qp_cost_nil(JCFG.mpc, adt, bdt, x0, inp.traj, jnp.ones((h,), jnp.float32))

    hess, grad = (np.asarray(a) for a in jax.vmap(form)(inputs))
    gait = np.asarray(inputs.gait_table)
    n, m, f_scale = 12 * h, 20 * h, JCFG.mpc.f_max
    hp = np.zeros((b, FA.N, FA.N), np.float32)
    hp[:, :n, :n] = hess * f_scale * f_scale
    hp[:, np.arange(n, FA.N), np.arange(n, FA.N)] = 1.0
    gp = np.zeros((b, FA.N), np.float32)
    gp[:, :n] = grad * f_scale
    u3 = np.full((b, h, 4, 5), JCFG.mpc.big_number, np.float32)
    u3[..., 4] = gait
    u = u3.reshape(b, -1)
    rho = np.asarray(JA.constraint_rho(JCFG.solver, np.zeros_like(u), u))
    lp = np.zeros((b, FA.M), np.float32)
    up = np.zeros((b, FA.M), np.float32)
    up[:, :m] = u
    rp = np.ones((b, FA.M), np.float32)
    rp[:, :m] = rho
    ap = np.zeros((FA.M, FA.N), np.float32)
    ap[:m, :n] = JA._pyramid_dense(JCFG.mpc.mu, h, 4)
    return ap, hp, gp, lp, up, rp


def test_reference_matches_jax_kernel_interpret():
    """K5's reference vs the JAX kernel in interpret mode at h=4, b=8, with
    a reduced n_iter=60 and polish_rounds=2 (the JAX test's 100 and 4 take
    ~30 s in interpret mode). Measured per-system max |d|: <= 0.19 N."""
    ops = _kernel_operands()
    kw = dict(n_iter=60, polish_rounds=2)
    x_j = np.asarray(JFA.fused_admm_solve(*ops, interpret=True, **kw))
    x_t = FA.fused_admm_solve(*map(torch.from_numpy, ops), **kw).numpy()
    f_scale = JCFG.mpc.f_max
    assert x_t.shape == (FA.G, FA.N) and np.isfinite(x_t).all()
    np.testing.assert_array_equal(x_t[:, 48:], 0.0)       # padded variables
    np.testing.assert_allclose(x_t * f_scale, x_j * f_scale, rtol=0, atol=0.5)
    # the ADMM phase alone (no polish) is the same arithmetic to ~1e-6
    kw0 = dict(n_iter=30, polish_rounds=0)
    x_j0 = np.asarray(JFA.fused_admm_solve(*ops, interpret=True, **kw0))
    x_t0 = FA.fused_admm_solve(*map(torch.from_numpy, ops), **kw0).numpy()
    np.testing.assert_allclose(x_t0, x_j0, rtol=0, atol=1e-5 * np.abs(x_j0).max())


SEED, BATCH, H = 5, 8, 10


@pytest.fixture(scope="module")
def fused_case():
    """(port inputs, JAX forces) for solve_packed_batch(use_fused=True) at
    h=10, b=8, the JAX kernel in interpret mode."""
    inputs = TP.random_inputs(SEED, BATCH, H, device="cpu")
    inp = JP.MPCInputs(**{k: jnp.asarray(v) for k, v in inputs.to_numpy().items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFA, "fused_admm_solve",
                   functools.partial(JFA.fused_admm_solve, interpret=True))
        f_j = np.asarray(jax.jit(lambda i: JP.solve_packed_batch(JCFG, i, use_fused=True))(inp))
    return inputs, f_j


@pytest.mark.parametrize("use_kernels", [True, False])
def test_fused_solve_matches_jax_interpret(fused_case, use_kernels):
    """Path A, both branches (on the CPU both run the reference): per
    scenario, one tile of n = 60 each (no packing), h=10. Measured max
    |d|: 0.147 N."""
    inputs, f_j = fused_case
    f_t = TP.solve_packed_batch(CFG, inputs, use_fused=True, use_kernels=use_kernels).numpy()
    assert f_t.shape == (BATCH, H, 4, 3) and np.isfinite(f_t).all()
    swing = inputs.gait_table.numpy() == 0
    assert (f_t[swing] == 0).all()
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=0.5)


def test_fused_solve_ignores_pack_and_form_only(fused_case):
    """As in the JAX function: the fused branch solves each scenario alone,
    so `pack` does not change its result and `form_only` does not apply."""
    inputs, _ = fused_case
    f = TP.solve_packed_batch(CFG, inputs, use_fused=True, iterations=40)
    assert torch.equal(TP.solve_packed_batch(CFG, inputs, pack=1, use_fused=True,
                                             iterations=40), f)
    assert torch.equal(TP.solve_packed_batch(CFG, inputs, use_fused=True, iterations=40,
                                             form_only=True), f)


def test_admm_mpc_fused_pads_the_batch_and_defaults():
    """admm_mpc_fused G-pads a batch of 3 with identity systems, as the JAX
    function does, and defaults to cfg.polish_rounds + 1 polish rounds:
    the same result as passing them explicitly, and each system's result
    does not depend on its batch neighbours."""
    inputs = TP.random_inputs(2, 3, 4, device="cpu")
    adt, bdt = TF.srb_discrete(CFG.mpc, inputs.r_feet, inputs.rpy[:, 2], inputs.x_drag,
                               CFG.dt_mpc)
    x0 = TF.build_x0(inputs.rpy, inputs.position, inputs.omega_world, inputs.v_world,
                     CFG.mpc.gravity)
    _, gait_red, sel = TF.stance_selectors(inputs.gait_table, 2)
    hess, grad = TF.qp_cost_compressed_nil_sel(
        CFG.mpc, adt, bdt, x0, inputs.traj, torch.ones((3, 4)), sel)
    calls = []
    real = FA.fused_admm_solve_reference

    def record(a, hp, *args, **kw):
        calls.append((hp.shape[0], kw["polish_rounds"]))
        return real(a, hp, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FA, "fused_admm_solve_reference", record)
        x3 = TA.admm_mpc_fused(CFG.solver, CFG.mpc, hess, grad, gait_red, use_kernels=False)
    assert calls == [(FA.G, CFG.solver.polish_rounds + 1)]
    x1 = TA.admm_mpc_fused(CFG.solver, CFG.mpc, hess[1:2], grad[1:2], gait_red[1:2],
                           polish_rounds=CFG.solver.polish_rounds + 1)
    assert x3.shape == (3, 24)
    np.testing.assert_allclose(x1.numpy(), x3[1:2].numpy(), rtol=0, atol=1e-4)


def test_wrapper_routes_cpu_to_reference_and_checks_inputs():
    ops = [torch.from_numpy(a) for a in _kernel_operands()]
    FA.fused_admm_solve.launches = 0
    kw = dict(n_iter=5, polish_rounds=1)
    assert torch.equal(FA.fused_admm_solve(*ops, **kw),
                       FA.fused_admm_solve_reference(*ops, **kw))
    assert FA.fused_admm_solve.launches == 0
    a, hp, gp, lp, up, rp = ops
    with pytest.raises(TypeError):
        FA.fused_admm_solve(a.double(), hp, gp, lp, up, rp)
    with pytest.raises(ValueError):
        FA.fused_admm_solve(a[:, :64].contiguous(), hp, gp, lp, up, rp)   # not the tile
    with pytest.raises(ValueError):
        FA.fused_admm_solve(a, hp, gp[:4], lp, up, rp)                    # batch mismatch
    with pytest.raises(ValueError):
        FA.fused_admm_solve(a, hp, gp, lp, up, rp.T.contiguous().T)       # not contiguous
    with pytest.raises(ValueError):
        FA.fused_admm_solve(a, hp, gp, lp, up, rp, n_scaled=17)           # mu table length
    assert (FA.N, FA.M, FA.G) == (JFA.N, JFA.M, JFA.G)
