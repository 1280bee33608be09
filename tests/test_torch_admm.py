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
from quadruped_ctrl_tpu.mpc import pipeline as JP
from quadruped_ctrl_tpu.ops import ns_inverse as JNI
from quadruped_ctrl_tpu.solver import admm as JA
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.mpc import pipeline as TP
from quadruped_ctrl_tpu_torch.ops import ns_inverse as TNI
from quadruped_ctrl_tpu_torch.solver import admm as TA
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


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


def test_woodbury_and_warm_paths_run():
    """The Woodbury polish (K6) runs on both branches, finite, at a batch
    (b = 2) that is not a multiple of the JAX kernels' group G: K6 takes any
    batch. So does the warm factorization (K7, `_batched_solver(prev_inv=...)`
    seeded from a cold one): its inverse and its solve are finite and the
    solve answers K x = b (parity with JAX: test_torch_warm_ns.py)."""
    prob = _problem(4, 2, 1, 3)
    wood = dataclasses.replace(CFG.solver, polish_woodbury=True)
    for use_kernels in (True, False):
        x = _port_solve(prob, use_kernels=use_kernels, cfg=wood)
        assert x.shape == (2, 48) and torch.isfinite(x).all()
    k = 2.0 * torch.eye(8) + 0.1 * torch.ones(8, 8)
    k = torch.stack([k, 1.5 * k])
    cold = TA._batched_solver(k, CFG.solver, True)
    warm = TA._batched_solver(1.1 * k, CFG.solver, True, prev_inv=cold.inv_padded,
                              prev_scale=cold.scale)
    x = warm(torch.ones(2, 8))
    assert warm.inv_padded.shape == (2, 128, 128) and torch.isfinite(warm.inv_padded).all()
    torch.testing.assert_close(1.1 * k @ x[:, :, None], torch.ones(2, 8, 1))


@pytest.mark.parametrize("pivot", [True, False])
def test_gj_inverse_matches_jax(pivot):
    """Gauss-Jordan with and without partial pivoting, against the JAX
    function on the same matrices: Woodbury capacitance-like matrices (a
    Gram block plus a +-1 diagonal; pivoting reorders their rows) to 1e-5
    relative, and the exact inverse in float64 to 1e-4 relative."""
    rng = np.random.default_rng(4)
    b, r = 6, 8
    v = rng.normal(size=(b, r, 12)).astype(np.float32)
    s = np.where(rng.uniform(size=(b, r)) < 0.5, 1.0, -1.0).astype(np.float32)
    c = (np.einsum("brk,bsk->brs", v, v) * 3.0 + s[:, :, None] * np.eye(r)).astype(np.float32)
    if not pivot:      # diagonally dominant: elimination without pivoting is stable
        c = c + 40.0 * np.eye(r, dtype=np.float32)
    x_j = np.asarray(JA._gj_inverse(jnp.asarray(c), pivot=pivot))
    x_t = TA._gj_inverse(torch.from_numpy(c), pivot=pivot).numpy()
    scale = np.abs(x_j).max()
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(x_t, np.linalg.inv(c.astype(np.float64)), rtol=0,
                               atol=1e-4 * scale)


def test_top_k_tie_order_matches_lax_top_k():
    """The Woodbury round picks the rows to update with lax.top_k on 0/1
    flags, which puts ties in index order; torch.topk promises no tie order.
    With more additions (1s) than rank, and with fewer, the port picks the
    same rows in the same order."""
    rng = np.random.default_rng(9)
    for p in (0.02, 0.1, 0.5):
        flags = (rng.uniform(size=(5, 200)) < p).astype(np.float32)
        _, idx_j = jax.lax.top_k(jnp.asarray(flags), 16)
        idx_t = TA._top_k_indices(torch.from_numpy(flags), 16)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


WB_JCFG = dataclasses.replace(
    JCFG, solver=dataclasses.replace(JCFG.solver, polish_woodbury=True))
WB_CFG = dataclasses.replace(CFG, solver=dataclasses.replace(CFG.solver, polish_woodbury=True))


def _pipeline_forces(inputs, jcfg, kernels: bool, max_stance: int = 2, pack: int = 2):
    """The JAX solve_packed_batch on the port's inputs, run eagerly as
    test_admm.py runs it (its result moves by up to 13 N under jit, ROADMAP
    queue 3); with `kernels`, every Pallas kernel on the path in interpret
    mode."""
    inp = JP.MPCInputs(**{k: jnp.asarray(v) for k, v in inputs.to_numpy().items()})
    with pytest.MonkeyPatch.context() as mp:
        if kernels:
            for name in ("ns_inverse_pallas_scaled", "ns_inverse_pallas_scaled_build",
                         "ns_inverse_pallas_refine"):
                mp.setattr(JNI, name, functools.partial(getattr(JNI, name), interpret=True))
            mp.setattr(JF, "qp_cost_packed", functools.partial(
                JF.qp_cost_packed, use_pallas=True, interpret=True))
            mp.setattr(JA, "admm_mpc_batched", functools.partial(
                JA.admm_mpc_batched, use_pallas=True))
        return np.asarray(JP.solve_packed_batch(jcfg, inp, max_stance=max_stance, pack=pack))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_woodbury_round_algebra(use_kernels):
    """One Woodbury round against float64 on a state whose stored inverse is
    exact, where no knife edge enters: the round applies the first `rank`
    additions by index (more additions than rank in system 0), defers every
    removal and keeps lo/hi swaps; its Jacobi-scaled K equals the previous K
    plus w_act a_r' a_r over the applied rows, rescaled (1e-5 relative); its
    refined inverse (K6's reference, or the plain fp32 steps) is that K's
    inverse (1e-4 relative) and the returned solve answers K x = b."""
    rng = np.random.default_rng(11)
    b, h, nf, rank, w_act = 3, 2, 2, 4, 10.0
    a = TA._pyramid_dense(0.4, h, nf).astype(np.float64)           # (20, 12)
    m, n = a.shape
    q, _ = np.linalg.qr(rng.normal(size=(b, n, n)))
    hess = (q * np.logspace(0, -1.5, n)[None, None]) @ q.transpose(0, 2, 1)
    act_p = rng.uniform(size=(b, m)) < 0.2
    act_p[0] = False
    k_p = hess + np.einsum("rn,brm,rk->bnk", a, np.eye(m)[None] * (w_act * act_p)[:, :, None],
                           a)
    dd_p = 1.0 / np.sqrt(np.einsum("bii->bi", k_p))
    ks_p = k_p * dd_p[:, :, None] * dd_p[:, None, :]
    lo_p = act_p & (rng.uniform(size=(b, m)) < 0.5)
    hi_p = act_p & ~lo_p
    # proposal: system 0 adds 7 rows (> rank); the others add, remove, swap
    act_d = act_p.copy()
    act_d[0, [1, 3, 4, 8, 9, 15, 18]] = True
    for s in (1, 2):
        on, off = np.flatnonzero(~act_p[s]), np.flatnonzero(act_p[s])
        act_d[s, on[:2]] = True
        act_d[s, off[:1]] = False
    lo_d = act_d & np.where(act_p, lo_p, True)
    hi_d = act_d & ~lo_d
    lo_d[2], hi_d[2] = np.where(act_p[2] & act_d[2], hi_p[2], lo_d[2]), \
        np.where(act_p[2] & act_d[2], lo_p[2], hi_d[2])        # swaps in system 2

    t = functools.partial(torch.tensor, dtype=torch.float32)
    seen = {}

    def apply_round(solve, w, bound, y_act, best_x, best_v, lo, hi):
        seen["solve"] = solve
        return best_x, best_v, lo, hi, y_act

    carry = (torch.zeros(b, n), torch.zeros(b), torch.from_numpy(lo_d),
             torch.from_numpy(hi_d), torch.zeros(b, m))
    state = (torch.from_numpy(lo_p), torch.from_numpy(hi_p), t(np.linalg.inv(ks_p)), t(ks_p),
             t(dd_p))
    _, (lo_n, hi_n, inv1, ks1s, dd_n) = TA._woodbury_round(
        CFG.solver, carry, state, t(a), rank, w_act, use_kernels,
        lambda lo, hi, y: (None, None, y), apply_round)

    add = act_d & ~act_p
    applied = np.zeros_like(add)
    for s in range(b):
        applied[s, np.flatnonzero(add[s])[:rank]] = True
    keep = (act_d != act_p) & ~applied
    np.testing.assert_array_equal(lo_n.numpy(), np.where(keep, lo_p, lo_d))
    np.testing.assert_array_equal(hi_n.numpy(), np.where(keep, hi_p, hi_d))
    assert applied[0].sum() == rank and add[0].sum() == 7 and keep[1:].any()
    k_1 = k_p + w_act * np.einsum("rn,br,rk->bnk", a, applied.astype(np.float64), a)
    d_1 = 1.0 / np.sqrt(np.einsum("bii->bi", k_1))
    ks_1 = k_1 * d_1[:, :, None] * d_1[:, None, :]
    np.testing.assert_allclose(dd_n.numpy(), d_1, rtol=1e-5)
    np.testing.assert_allclose(ks1s.numpy(), ks_1, rtol=0, atol=1e-5)
    inv_1 = np.linalg.inv(ks_1)
    np.testing.assert_allclose(inv1.numpy(), inv_1, rtol=0, atol=1e-4 * np.abs(inv_1).max())
    rhs = rng.normal(size=(b, n))
    x = seen["solve"](t(rhs)).numpy()
    x_64 = np.linalg.solve(k_1, rhs[:, :, None])[..., 0]
    np.testing.assert_allclose(x, x_64, rtol=0, atol=1e-4 * np.abs(x_64).max())


WB_B = 32


@pytest.fixture(scope="module")
def woodbury_inputs():
    """random_inputs(PRNGKey(2), 32, 10) of the JAX package, as the port's:
    its first 8 scenarios are test_admm.py::
    test_polish_woodbury_path_runs_and_is_guarded's inputs."""
    jinp = JP.random_inputs(jax.random.PRNGKey(2), WB_B, 10)
    return TP.MPCInputs.from_numpy(
        {f.name: np.asarray(getattr(jinp, f.name)) for f in dataclasses.fields(TP.MPCInputs)},
        device="cpu")


@pytest.mark.parametrize("use_kernels", [False, True])
def test_woodbury_solve_matches_jax(woodbury_inputs, use_kernels):
    """Path B at h=10 (K2 x 3, then K6 x 2 on the kernel branch), each
    branch against the JAX branch that routes alike (XLA; Pallas in
    interpret mode), per scenario over 32 scenarios. The Woodbury polish is
    knife-edge in fp32 (config.py's note): the JAX solve of the first 8
    moves by 13.07 N on one scenario between its eager and its jit run, and
    by up to 4.63 N when its packed H takes one-ulp noise. So the gates are
    a share and the median, with margins measured on these inputs:
    plain, 28 of 32 scenarios within 0.5 N (gate 24), median 0.07 N, max
    2.00 N (gate 5 N); kernel, 24 of 32 within 0.5 N (gate 20), median
    0.095 N, max 13.0 N (not gated: the JAX solve's own eager-to-jit move);
    median gate 0.15 N on both. test_woodbury_round_algebra holds one round
    to float64 without these knife edges. Against its own default-config
    solve the port is held to the JAX test's guard, max < 40 N (measured
    12.2 N plain, 12.8 N kernel)."""
    f_t = TP.solve_packed_batch(WB_CFG, woodbury_inputs, use_kernels=use_kernels).numpy()
    f_j = _pipeline_forces(woodbury_inputs, WB_JCFG, kernels=use_kernels)
    assert f_t.shape == (WB_B, 10, 4, 3) and np.isfinite(f_t).all()
    per_scn = np.abs(f_t - f_j).reshape(WB_B, -1).max(axis=1)
    within = int((per_scn <= 0.5).sum())
    assert within >= (20 if use_kernels else 24) and np.median(per_scn) <= 0.15, per_scn
    assert use_kernels or per_scn.max() <= 5.0, per_scn
    f_cold = TP.solve_packed_batch(CFG, woodbury_inputs, use_kernels=use_kernels).numpy()
    assert np.abs(f_t - f_cold).max() < 40.0


def test_woodbury_solve_at_256_tile(monkeypatch):
    """Path B at h=16 (h16_full: max_stance 4, pack 1, n = 192), b = 2, seed
    8. The plain branch against the JAX XLA path within 0.5 N (measured
    0.152 N). The kernel branch (the kernels' references) routes as the JAX
    code: K2 at 256 emits no ks, so every factorization takes the two-step
    build (K3 x 3), and the two Woodbury rounds K6 at 256; it is held to the
    JAX test's guard against its own default-config solve (max < 40 N;
    measured 24.1 N).
    Kernel and plain branch are not compared: at h=16 the Woodbury rounds
    amplify the two branches' NS arithmetic to 3-24 N on most scenarios,
    as one-ulp input changes move the JAX solve by up to 19 N (ROADMAP
    queue 3)."""
    inputs = TP.random_inputs(8, 2, 16, device="cpu")
    kw = dict(max_stance=4, pack=1)
    f_t = TP.solve_packed_batch(WB_CFG, inputs, **kw).numpy()
    f_j = _pipeline_forces(inputs, WB_JCFG, kernels=False, **kw)
    assert np.isfinite(f_t).all()
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=0.5)
    calls = []
    for name in ("ns_inverse_scaled_build", "ns_inverse_scaled", "ns_inverse_refine"):
        real = getattr(TNI, name)

        def record(first, *args, _name=name, _real=real, **kwargs):
            calls.append((_name, first.shape[-1]))
            return _real(first, *args, **kwargs)

        monkeypatch.setattr(TNI, name, record)
    f_k = TP.solve_packed_batch(WB_CFG, inputs, use_kernels=True, **kw).numpy()
    assert calls == [("ns_inverse_scaled", 256)] * 3 + [("ns_inverse_refine", 256)] * 2
    assert np.isfinite(f_k).all()
    f_cold = TP.solve_packed_batch(CFG, inputs, use_kernels=True, **kw).numpy()
    assert np.abs(f_k - f_cold).max() < 40.0
