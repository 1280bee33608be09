"""Random controllable MPC problem generator (the JCQP test pattern).

The counterpart of `quadruped_ctrl_tpu/solver/problem_generator.py`, in
numpy as there (reference src/JCQP/ProblemGenerator.cpp:9-40): random
discrete-time systems with bounded eigenvalues, controllable, rolled into
condensed MPC QPs with box bounds, for testing QP solvers on problems of
controlled difficulty.
"""

from __future__ import annotations

import numpy as np


def random_mpc_qp(rng, n_states=12, n_controls=12, horizon=10,
                  spectral_radius=0.98, state_cost=1.0, control_cost=1e-3):
    """Returns (hess, grad, a_mat, l, u), float64 numpy: a condensed MPC QP
    over the controls with box bounds, from a random stable controllable
    system drawn from the numpy Generator `rng`."""
    a = rng.normal(size=(n_states, n_states))
    eig = np.abs(np.linalg.eigvals(a)).max()
    a = a * (spectral_radius / eig)
    b = rng.normal(size=(n_states, n_controls)) / np.sqrt(n_controls)

    # controllability check (generic random systems always pass)
    ctrb = np.hstack([np.linalg.matrix_power(a, k) @ b for k in range(n_states)])
    assert np.linalg.matrix_rank(ctrb) == n_states

    x0 = rng.normal(size=n_states)
    powers = [np.eye(n_states)]
    for _ in range(horizon):
        powers.append(a @ powers[-1])
    a_qp = np.vstack([powers[k + 1] for k in range(horizon)])
    b_qp = np.zeros((n_states * horizon, n_controls * horizon))
    for r in range(horizon):
        for c in range(r + 1):
            b_qp[r * n_states:(r + 1) * n_states,
                 c * n_controls:(c + 1) * n_controls] = powers[r - c] @ b

    q = state_cost * np.eye(n_states * horizon)
    hess = 2.0 * (b_qp.T @ q @ b_qp + control_cost * np.eye(n_controls * horizon))
    grad = 2.0 * b_qp.T @ q @ (a_qp @ x0)

    n = n_controls * horizon
    a_mat = np.eye(n)
    bound = rng.uniform(0.5, 2.0, n)
    return hess, grad, a_mat, -bound, bound
