"""PyTorch port vs JAX package: the batched packed MPC solve
`solve_packed_batch` end to end at h=10, batch 4 (two packed 120-variable
systems), on the CPU with the same numpy inputs fed to both.

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

from quadruped_ctrl_tpu.config import default_config
from quadruped_ctrl_tpu.mpc import formation as JF
from quadruped_ctrl_tpu.mpc import pipeline as JP
from quadruped_ctrl_tpu.ops import ns_inverse as JNI
from quadruped_ctrl_tpu.solver import admm as JA
from quadruped_ctrl_tpu_torch.mpc import pipeline as TP

CFG = default_config()
SEED, BATCH, H = 5, 4, 10


@pytest.fixture(scope="module")
def inputs():
    return TP.random_inputs(SEED, BATCH, H)


def _jax_forces(inputs, kernels: bool):
    inp = JP.MPCInputs(**{k: jnp.asarray(v) for k, v in inputs.to_numpy().items()})
    with pytest.MonkeyPatch.context() as mp:
        if kernels:
            for name in ("ns_inverse_pallas_scaled", "ns_inverse_pallas_scaled_build"):
                mp.setattr(JNI, name, functools.partial(getattr(JNI, name), interpret=True))
            mp.setattr(JF, "qp_cost_packed", functools.partial(
                JF.qp_cost_packed, use_pallas=True, interpret=True))
            mp.setattr(JA, "admm_mpc_batched", functools.partial(
                JA.admm_mpc_batched, use_pallas=True))
        return np.asarray(jax.jit(lambda i: JP.solve_packed_batch(CFG, i))(inp))


def _swing_zero(forces, inputs):
    swing = inputs.gait_table.numpy() == 0
    return bool((forces[swing] == 0).all())


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
    inp = TP.random_inputs(3, 64, 8)
    arrays = inp.to_numpy()
    again = TP.MPCInputs.from_numpy(arrays)
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
    with pytest.raises(NotImplementedError, match="K5"):
        TP.solve_packed_batch(CFG, inputs, use_fused=True)
    with pytest.raises(ValueError):
        TP.solve_packed_batch(CFG, TP.random_inputs(0, 3, H))
