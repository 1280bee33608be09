"""The port's batched stage-wise MPC solve, `mpc/sparse.solve_sparse_batch`
(`solve_sparse` under `torch.func.vmap`), on the CPU at h = 6 with the
reference's initSparseMPC weights and mu (the defaults of `solve_sparse`):

- `build_sparse_qp` under vmap against the per-scenario build;
- the batched solve against a per-scenario loop of `solve_sparse`, by forces
  and by the float64 reference's cost;
- against `jax.vmap` of the JAX package's `solve_sparse` (0.5 N on the
  first step's fz, 1.5 N overall, from the measured difference);
- against the benchmark's float64 reference of the condensed QP
  (`benchmark/reference/mpc_qp.py`, through `benchmark/harness/check.judge`):
  with these weights and mu the stage-wise and condensed QPs are one problem
  in different variables, so the cost gap and the constraint violation of
  the batched forces are gated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.harness import check
from quadruped_ctrl_tpu.config import default_config as jax_default_config
from quadruped_ctrl_tpu.mpc import pipeline as j_pipe
from quadruped_ctrl_tpu.mpc import sparse as j_sparse
from quadruped_ctrl_tpu_torch import default_config
from quadruped_ctrl_tpu_torch.core.types import tree_map, vmap
from quadruped_ctrl_tpu_torch.mpc import pipeline as t_pipe
from quadruped_ctrl_tpu_torch.mpc import sparse as t_sparse
from tests.test_torch_package import _one_thread  # noqa: F401

CFG, JCFG = default_config(), jax_default_config()
H, B = 6, 8

# the configuration the reference judges: the port's model constants with
# initSparseMPC's weights and mu
MPC = dict(dt=1.0 / CFG.sim.freq, iterations_between_mpc=CFG.mpc.iterations_between_mpc,
           mass=CFG.mpc.mass, inertia=list(CFG.mpc.inertia),
           weights=list(t_sparse.SPARSE_WEIGHTS), alpha=CFG.mpc.alpha, mu=t_sparse.SPARSE_MU,
           f_max=CFG.mpc.f_max, gravity=CFG.mpc.gravity)


@pytest.fixture(scope="module")
def solved():
    """Eight seeded trot scenarios, their batched solve and the loop's."""
    torch.set_num_threads(1)
    inp = t_pipe.random_inputs(11, B, H, device="cpu")
    batched = t_sparse.solve_sparse_batch(CFG, inp)
    loop = torch.stack([t_sparse.solve_sparse(CFG, tree_map(lambda t: t[b], inp))
                        for b in range(B)])
    return inp, batched, loop


def _raw(inp):
    return {k: getattr(inp, k) for k in check.FIELDS}


def test_build_sparse_qp_batches_under_vmap():
    """The out-of-place build under vmap gives each scenario's own QP; the
    only product in it (A x0 in the first step's affine term) may round
    differently batched, so 1e-6 as the JAX comparison's gate."""
    inp = t_pipe.random_inputs(5, 4, H, device="cpu")
    got = vmap(lambda i: t_sparse.build_sparse_qp(CFG, i, H))(inp)
    for b in range(4):
        want = t_sparse.build_sparse_qp(CFG, tree_map(lambda t: t[b], inp), H)
        for name, g, w in zip(("hess", "grad", "a_mat", "l", "u"), got, want):
            np.testing.assert_allclose(g[b].numpy(), w.numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def test_solve_sparse_batch_matches_the_per_scenario_loop(solved):
    """Batched products sum in another order than the loop's matvecs, and
    150 ADMM iterations carry that rounding into the directions in which
    the stage-wise cost is flat: the forces differ by 0.18-0.35 N over ten
    seeds here (1 N gates them, under 1% of f_max), while the float64
    reference's costs of the two differ by 6.0e-7-5.1e-6 of the optimum's
    over four seeds (gated at 3e-5, as the reference test gates each one's
    largest gap)."""
    inp, batched, loop = solved
    assert batched.shape == (B, H, 4, 3)
    assert torch.isfinite(batched).all()
    np.testing.assert_allclose(batched.numpy(), loop.numpy(), atol=1.0)
    from benchmark.reference.mpc_qp import Reference

    ref = Reference(MPC)
    raw = _raw(inp)
    j_opt = ref.cost(raw, ref.solve(raw)[0])
    diff = (ref.cost(raw, batched.double()) - ref.cost(raw, loop.double())).abs() / j_opt
    assert float(diff.max()) < 3e-5


def test_solve_sparse_batch_matches_jax_vmap(solved):
    """Both packages solve the same stage-wise formulation, so only their
    rounding differs: over six seeds of eight scenarios here the forces
    differ by 0.29-0.47 N at most (fx and fy mostly, as the loop comparison
    above) and the first step's fz by 0.05-0.19 N. The gates, 1.5 N overall
    and 0.5 N on the first step's fz (the force the robot applies), leave
    about 3x of room."""
    inp, batched, _ = solved
    jinp = j_pipe.MPCInputs(**{k: jnp.asarray(v) for k, v in inp.to_numpy().items()})
    want = np.asarray(jax.jit(jax.vmap(lambda i: j_sparse.solve_sparse(JCFG, i)))(jinp))
    got = batched.numpy()
    np.testing.assert_allclose(got[:, 0, :, 2], want[:, 0, :, 2], atol=0.5)
    np.testing.assert_allclose(got, want, atol=1.5)


def test_solve_sparse_batch_against_the_float64_reference(solved):
    """The batched forces judged as the benchmark judges a run. Measured
    over three seeds here: gap_p50 3.1e-7-4.5e-7, the largest gap
    2.0e-6-4.7e-6, violations 1.5e-5-2.3e-5 N. The gates leave 4-6x of
    room for other seeds, and stay below what a lower precision reads:
    the TF32 control's least gap_p90 at h = 16 is 1.34e-4 (PERF.md
    section 2). The violation gate, 1e-3 N, lies 40x above the measured
    violations and far below the 5 N that the benchmark's planted faults
    put outside the constraints."""
    inp, batched, _ = solved
    numbers = check.judge(MPC, _raw(inp), batched)
    assert numbers["ref_dual"] < 1e-9 and numbers["ref_primal_N"] < 1e-6
    assert numbers["gap_p50"] < 2e-6
    assert numbers["gap_max"] < 3e-5
    assert numbers["viol_max_N"] < 1e-3
