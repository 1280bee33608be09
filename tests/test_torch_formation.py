"""PyTorch port vs JAX package: MPC formation and the packed formation
kernel's reference (K1), on the CPU with numpy inputs made from a seed.

Tolerances are the JAX tests' own for the same functions: test_formation.py
(hess 1e-6 x scale, grad 1e-5) and test_pallas_kernels.py (packed formation
rel_H < 5e-5, rel_g < 1e-5 against the fp32 XLA path).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.mpc import formation as JF
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.mpc import formation as TF
from quadruped_ctrl_tpu_torch.ops import formation_pack as FP
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


JCFG = jax_default_config()     # drives the JAX side
CFG = default_config()          # the port's own


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def _scenarios(seed, b, h, ms=2, jax_test_table=False):
    """Random scenario batch (numpy) with a gait of at most ms stance feet
    per step; returns the arrays the formation consumes. With
    `jax_test_table` the gait is drawn as test_pallas_kernels.py draws its
    ms >= 3 tables: stance with probability 0.75, foot 0 always in stance,
    clamped to ms per step."""
    rng = np.random.default_rng(seed)
    r_feet = rng.uniform(-0.25, 0.25, (b, 4, 3)).astype(np.float32)
    r_feet[:, :, 2] = rng.uniform(-0.30, -0.25, (b, 4))
    yaw = rng.uniform(-0.5, 0.5, b).astype(np.float32)
    x_drag = rng.uniform(0.0, 1.0, b).astype(np.float32)
    x0 = np.concatenate([rng.uniform(-0.3, 0.3, (b, 12)),
                         np.full((b, 1), -9.8)], axis=1).astype(np.float32)
    traj = np.concatenate([rng.uniform(-0.5, 0.5, (b, h, 12)),
                           np.zeros((b, h, 1))], axis=2).astype(np.float32)
    gait = (rng.uniform(size=(b, h, 4)) < (0.75 if jax_test_table else 0.6)
            ).astype(np.float32)
    if jax_test_table:
        gait[:, :, 0] = 1.0
    for s in range(b):
        for x in range(h):
            on = np.flatnonzero(gait[s, x])
            gait[s, x, on[ms:]] = 0.0
    return dict(r_feet=r_feet, yaw=yaw, x_drag=x_drag, x0=x0, traj=traj, gait=gait)


def test_pyramid_and_x0_match_jax():
    rng = np.random.default_rng(0)
    h = 6
    gait = (rng.uniform(size=(h, 4)) < 0.5).astype(np.float32)
    x = rng.normal(size=(3, h, 4, 3)).astype(np.float32)
    y = rng.normal(size=(3, h, 4, 5)).astype(np.float32)
    rho = rng.uniform(0.5, 2.0, size=(3, h, 4, 5)).astype(np.float32)
    for t, j in zip(TF.pyramid_bounds(CFG.mpc, _t(gait)),
                    JF.pyramid_bounds(JCFG.mpc, jnp.asarray(gait))):
        _close(t, j, 0.0)
    _close(TF.pyramid_apply(CFG.mpc, _t(x)), JF.pyramid_apply(JCFG.mpc, x), 1e-6)
    _close(TF.pyramid_apply_t(CFG.mpc, _t(y)), JF.pyramid_apply_t(JCFG.mpc, y), 1e-6)
    _close(TF.pyramid_gram(CFG.mpc, _t(rho)), JF.pyramid_gram(JCFG.mpc, rho), 1e-5)
    parts = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4)]
    _close(TF.build_x0(*map(_t, parts), 9.8), JF.build_x0(*parts, 9.8), 0.0)


def test_srb_discrete_and_stance_selectors_match_jax():
    sc = _scenarios(1, 7, 10, ms=4)
    adt_t, bdt_t = TF.srb_discrete(CFG.mpc, _t(sc["r_feet"]), _t(sc["yaw"]),
                                   _t(sc["x_drag"]), CFG.dt_mpc)
    adt_j, bdt_j = JF.srb_discrete(JCFG.mpc, sc["r_feet"], sc["yaw"],
                                   sc["x_drag"], CFG.dt_mpc)
    _close(adt_t, adt_j, 1e-6)
    _close(bdt_t, bdt_j, 1e-6)
    _close(TF._phi_polys(10), JF._phi_polys(10, jnp.float32), 0.0)
    for ms in (1, 2, 4):
        for t, j in zip(TF.stance_selectors(_t(sc["gait"]), ms),
                        JF.stance_selectors(jnp.asarray(sc["gait"]), ms)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_scatter_forces_matches_jax():
    sc = _scenarios(2, 3, 5, ms=2)
    foot_idx, _, _ = TF.stance_selectors(_t(sc["gait"]), 2)
    x_red = np.random.default_rng(3).normal(size=(3, 5 * 2 * 3)).astype(np.float32)
    forces = TF.scatter_forces(_t(x_red), foot_idx, 5)
    for s in range(3):
        want = JF.scatter_forces(jnp.asarray(x_red[s]),
                                 jnp.asarray(foot_idx[s].numpy()), 5)
        _close(forces[s], want, 0.0)


def _formation_inputs(seed, b, h, ms):
    sc = _scenarios(seed, b, h, ms, jax_test_table=h == 16 and ms >= 3)
    adt, bdt = JF.srb_discrete(JCFG.mpc, sc["r_feet"], sc["yaw"], sc["x_drag"],
                               JCFG.dt_mpc)
    _, _, sel = JF.stance_selectors(jnp.asarray(sc["gait"]), ms)
    mask = np.ones((b, h), np.float32)
    mask[:, -2:] = 0.0                       # exercise the step-mask rows
    return [np.asarray(a) for a in (adt, bdt, sc["x0"], sc["traj"], mask, sel)]


def test_qp_cost_compressed_nil_sel_and_operands_match_jax():
    args = _formation_inputs(4, 5, 10, 2)
    h_t, g_t = TF.qp_cost_compressed_nil_sel(CFG.mpc, *map(_t, args))
    h_j, g_j = JF.qp_cost_compressed_nil_sel(JCFG.mpc, *args)
    scale = float(np.abs(np.asarray(h_j)).max())
    _close(h_t, h_j, 1e-6 * max(scale, 1.0))
    _close(g_t, g_j, 1e-5)
    for t, j in zip(TF.packed_qp_operands(CFG.mpc, *map(_t, args)),
                    JF.packed_qp_operands(JCFG.mpc, *args)):
        _close(t, j, 1e-5 * max(float(np.abs(np.asarray(j)).max()), 1.0))


@pytest.mark.parametrize("h,ms,pack,b", [
    (10, 2, 2, 8),      # the flagship shape (120-variable pairs, 128 tile)
    (10, 2, 2, 6),      # an odd system count (3 pairs)
    (4, 3, 1, 4),       # unpacked, three stance slots
    (16, 2, 2, 4),      # h=16 fast-trot band: 192-variable pairs, 256 tile
    (16, 3, 1, 2),      # h=16 walking band: 144 variables, 256 tile
    (16, 4, 1, 2),      # h=16 uncompressed: 192 variables, n_c = 192 > 128
])
def test_packed_formation_matches_jax(h, ms, pack, b):
    """qp_cost_packed through K1's reference (use_kernels=True on CPU) and
    through the plain branch, against the JAX XLA path and the JAX Pallas
    kernel in interpret mode."""
    args = _formation_inputs(10 + h * ms + pack, b, h, ms)

    def jax_packed(interpret):
        fn = jax.jit(functools.partial(JF.qp_cost_packed, JCFG.mpc, pack=pack,
                                       use_pallas=False, interpret=interpret))
        return (np.asarray(a) for a in fn(*args))

    h_x, g_x = jax_packed(interpret=False)
    h_i, g_i = jax_packed(interpret=True)
    h_k, g_k = (a.numpy() for a in TF.qp_cost_packed(
        CFG.mpc, *map(_t, args), pack, use_kernels=True))
    h_p, g_p = (a.numpy() for a in TF.qp_cost_packed(
        CFG.mpc, *map(_t, args), pack, use_kernels=False))

    def rel(a, ref):
        return float(np.abs(a - ref).max() / np.abs(ref).max())

    n_pair = pack * 3 * ms * h
    assert h_k.shape == (b // pack, n_pair, n_pair)
    assert g_k.shape == (b // pack, n_pair)
    # K1 reference (bf16x3 Gram) vs the fp32 XLA path: measured <= 1.9e-5 / 1.6e-7
    assert rel(h_k, h_x) < 5e-5 and rel(g_k, g_x) < 1e-5, (rel(h_k, h_x), rel(g_k, g_x))
    # vs the Pallas kernel under interpret mode: measured <= 6.5e-7 / 1.6e-7
    assert rel(h_k, h_i) < 5e-5 and rel(g_k, g_i) < 1e-5, (rel(h_k, h_i), rel(g_k, g_i))
    # plain branch vs the XLA path: same fp32 arithmetic
    np.testing.assert_allclose(h_p, h_x, rtol=0, atol=1e-6 * np.abs(h_x).max())
    np.testing.assert_allclose(g_p, g_x, rtol=0, atol=1e-5)
    # the packed H is block diagonal: zeros off the scenario blocks
    n_c = n_pair // pack
    for i in range(pack):
        for j in range(pack):
            if i != j:
                assert not h_k[:, i * n_c:(i + 1) * n_c, j * n_c:(j + 1) * n_c].any()


def test_form_packed_wrapper_checks_and_cpu_route():
    args = _formation_inputs(5, 4, 10, 2)
    ops = TF.packed_qp_operands(CFG.mpc, *map(_t, args))
    FP.form_packed.launches = 0
    out = FP.form_packed(*ops, 10, 2, 2, 4e-5)
    ref = FP.form_packed_reference(*ops, 10, 2, 2, 4e-5)
    assert FP.form_packed.launches == 0
    for a, r in zip(out, ref):
        assert torch.equal(a, r)
    bfam_s, smat, r, smask = ops
    with pytest.raises(TypeError):
        FP.form_packed(bfam_s.double(), smat, r, smask, 10, 2, 2, 4e-5)
    with pytest.raises(ValueError):
        FP.form_packed(bfam_s, smat[:, :, :-3], r, smask, 10, 2, 2, 4e-5)
    with pytest.raises(ValueError):
        FP.form_packed(bfam_s[:3], smat[:3], r[:3], smask[:3], 10, 2, 2, 4e-5)
    with pytest.raises(ValueError):
        FP.form_packed(bfam_s, smat, r, torch.stack([smask, smask], -1)[..., 0],
                       10, 2, 2, 4e-5)
