"""PyTorch port vs JAX package: the batched ADMM solve `admm_mpc_batched`,
both branches, on the CPU with the same numpy problems fed to both.

Tolerances are the JAX tests' own for the same comparisons
(test_pallas_kernels.py, test_batched_mpc_path.py): 0.15 N between fp32
paths that compute the same thing, 0.5 N between the kernel branch and its
counterpart, 0.25 N between the fused and the two-step build. The solve is
sensitive at that level: the JAX solve itself moves by up to ~0.18 N when
its inputs move by one ulp, and flips a knife-edge active set by several N
in a few scenarios in a thousand, so the cases below use seeds on which both
packages resolve every active set alike (measured margins in the comments).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.mpc import formation as JF
from quadruped_ctrl_tpu.ops import ns_inverse as JNI
from quadruped_ctrl_tpu.solver import admm as JA
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.mpc import pipeline as TP
from quadruped_ctrl_tpu_torch.ops import ns_inverse as TNI
from quadruped_ctrl_tpu_torch.solver import admm as TA

JCFG = jax_default_config()     # drives the JAX side
CFG = default_config()          # the port's own


def _problem(h, b, pack, seed):
    """(hess, grad, gait, pack) as numpy: per-scenario uncompressed QPs
    (qp_cost_nil) when pack == 1, else stance-compressed pair-packed ones."""
    inp = TP.random_inputs(seed, b, h, device="cpu").to_numpy()
    adt, bdt = JF.srb_discrete(JCFG.mpc, inp["r_feet"], inp["rpy"][:, 2],
                               inp["x_drag"], JCFG.dt_mpc)
    x0 = JF.build_x0(inp["rpy"], inp["position"], inp["omega_world"],
                     inp["v_world"], JCFG.mpc.gravity)
    if pack == 1:
        hess, grad = jax.vmap(lambda a, bb, x, t: JF.qp_cost_nil(
            JCFG.mpc, a, bb, x, t, jnp.ones((h,), jnp.float32)))(adt, bdt, x0, inp["traj"])
        gait = inp["gait_table"]
    else:
        _, gait_red, sel = JF.stance_selectors(jnp.asarray(inp["gait_table"]), 2)
        hess, grad = JF.qp_cost_packed(JCFG.mpc, adt, bdt, x0, inp["traj"],
                                       jnp.ones((b, h), jnp.float32), sel, pack)
        gait = np.asarray(gait_red).reshape(b // pack, pack * h, 2)
    return np.asarray(hess), np.asarray(grad), np.asarray(gait, np.float32), pack


def _jax_solve(prob, use_pallas, **kw):
    hess, grad, gait, pack = prob
    fn = jax.jit(lambda hh, gg, tt: JA.admm_mpc_batched(
        JCFG.solver, JCFG.mpc, hh, gg, tt, use_pallas=use_pallas, pack=pack, **kw))
    return np.asarray(fn(hess, grad, gait))


def _port_solve(prob, use_kernels, cfg=CFG.solver, **kw):
    hess, grad, gait, pack = prob
    out = TA.admm_mpc_batched(cfg, CFG.mpc, torch.from_numpy(hess.copy()),
                              torch.from_numpy(grad.copy()), torch.from_numpy(gait.copy()),
                              use_kernels=use_kernels, pack=pack, **kw)
    return out


@pytest.fixture
def jax_kernels_interpret(monkeypatch):
    """Route the JAX package's NS kernels through Pallas interpret mode, as
    test_pallas_kernels.py does."""
    for name in ("ns_inverse_pallas_scaled", "ns_inverse_pallas_scaled_build"):
        monkeypatch.setattr(JNI, name, functools.partial(getattr(JNI, name), interpret=True))


CASES = [(4, 6, 1, 4), (10, 4, 2, 5)]      # (h, b, pack, seed)


@pytest.mark.parametrize("h,b,pack,seed", CASES)
def test_plain_branch_matches_jax(h, b, pack, seed):
    """Measured max |d|: 0.055 N (h=4) and 0.054 N (h=10)."""
    prob = _problem(h, b, pack, seed)
    x_j = _jax_solve(prob, use_pallas=False)
    x_t = _port_solve(prob, use_kernels=False).numpy()
    assert np.isfinite(x_t).all()
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=0.15)


@pytest.mark.parametrize("h,b,pack,seed", CASES)
def test_kernel_branch_matches_jax_interpret(jax_kernels_interpret, h, b, pack, seed):
    """Kernel branch (the kernels' references on the CPU; h=4, b=6 pads the
    batch to the G=8 group) vs the JAX Pallas branch under interpret mode.
    Measured max |d|: 0.044 N (h=4) and 0.086 N (h=10)."""
    prob = _problem(h, b, pack, seed)
    x_j = _jax_solve(prob, use_pallas=True)
    x_t = _port_solve(prob, use_kernels=True).numpy()
    assert np.isfinite(x_t).all()
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=0.5)


@pytest.mark.parametrize("h,b,pack,seed", CASES)
def test_two_step_build_matches_fused(monkeypatch, h, b, pack, seed):
    prob = _problem(h, b, pack, seed)
    x_f = _port_solve(prob, use_kernels=True).numpy()
    monkeypatch.setattr(TA, "_FUSED_BUILD", False)
    x_2 = _port_solve(prob, use_kernels=True).numpy()
    np.testing.assert_allclose(x_2, x_f, rtol=0, atol=0.25)


@pytest.mark.parametrize("h,seed", [(11, 18), (12, 17)])
def test_schur_split_solve_matches_jax_interpret(jax_kernels_interpret, monkeypatch, h, seed):
    """n = 132 and n = 144 (128 < n <= 160, pack 1): the two ADMM-grade
    factorizations take the Schur split K4 (K3 at the 128 tile on the
    leading block), the three polish ones K2 at the 256 tile, against the
    JAX Pallas branch under interpret mode, which routes alike.
    Measured max |d|: 0.028 N (n=132) and 0.047 N (n=144)."""
    prob = _problem(h, 4, 1, seed)
    real = TNI.ns_inverse_schur_scaled
    calls = []

    def record(ks, *schedule):
        calls.append(ks.shape)
        return real(ks, *schedule)

    monkeypatch.setattr(TNI, "ns_inverse_schur_scaled", record)
    x_t = _port_solve(prob, use_kernels=True).numpy()
    x_j = _jax_solve(prob, use_pallas=True)
    assert calls == [(4, 12 * h, 12 * h)] * 2
    assert np.isfinite(x_t).all()
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=0.5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_warm_start_contract(use_kernels):
    """Zeros as `warm` are exactly the cold start; `return_warm` gives the
    pre-polish iterate in normalized units, which warm-starts a next solve."""
    prob = _problem(4, 4, 1, 2)
    n, m = 48, 80
    cold, (wx, wz, wy) = _port_solve(prob, use_kernels, return_warm=True)
    assert wx.shape == (4, n) and wz.shape == (4, m) and wy.shape == (4, m)
    zeros = (torch.zeros(4, n), torch.zeros(4, m), torch.zeros(4, m))
    assert torch.equal(_port_solve(prob, use_kernels, warm=zeros), cold)
    warm = _port_solve(prob, use_kernels, warm=(wx, wz, wy), iterations=40)
    assert torch.isfinite(warm).all()
    np.testing.assert_allclose(warm.numpy(), cold.numpy(), rtol=0, atol=0.5)


def test_helpers_match_jax():
    s = CFG.solver
    rng = np.random.default_rng(7)
    l = np.zeros((3, 40), np.float32)
    u = np.where(rng.uniform(size=(3, 40)) < 0.3, 0.0,
                 np.where(rng.uniform(size=(3, 40)) < 0.5, 5e10, 1.0)).astype(np.float32)
    np.testing.assert_array_equal(TA.constraint_rho(s, torch.from_numpy(l), torch.from_numpy(u)),
                                  np.asarray(JA.constraint_rho(JCFG.solver, l, u)))
    ax, z, hx, g, aty = (rng.normal(size=(5, 30)).astype(np.float32) for _ in range(5))
    np.testing.assert_allclose(
        TA._adapt_rho_factor(s, *map(torch.from_numpy, (ax, z, hx, g, aty))).numpy(),
        np.asarray(JA._adapt_rho_factor(JCFG.solver, ax, z, hx, g, aty)), rtol=1e-6)
    np.testing.assert_array_equal(TA._pyramid_dense(0.4, 3, 2), JA._pyramid_dense(0.4, 3, 2))
    q, _ = np.linalg.qr(rng.normal(size=(2, 24, 24)))
    ks = (q * np.logspace(0, -2, 24)[None, None]) @ q.transpose(0, 2, 1)
    d = 1.0 / np.sqrt(np.einsum("bii->bi", ks))
    ks = (ks * d[:, :, None] * d[:, None, :]).astype(np.float32)
    inv_j = np.asarray(jax.vmap(lambda m: JA._ns_inverse(m, s.ns_iters))(ks))
    np.testing.assert_allclose(TA._ns_inverse(torch.from_numpy(ks), s.ns_iters).numpy(),
                               inv_j, rtol=0, atol=1e-4 * np.abs(inv_j).max())


def test_unported_paths_raise():
    prob = _problem(4, 2, 1, 3)
    wood = dataclasses.replace(CFG.solver, polish_woodbury=True)
    with pytest.raises(NotImplementedError, match="K6"):
        _port_solve(prob, use_kernels=True, cfg=wood)
    ks = torch.eye(8).expand(2, 8, 8).contiguous()
    with pytest.raises(NotImplementedError, match="K7"):
        TA._batched_solver(ks, CFG.solver, True, prev_inv=ks, prev_scale=torch.ones(2, 8))
