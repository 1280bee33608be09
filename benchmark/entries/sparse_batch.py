"""Entry: the port's batched stage-wise ("sparse") MPC solve,
`mpc/sparse.solve_sparse_batch`, one call per batch of scenarios, with the
configuration's weights, mu, iterations and polish rounds."""

from __future__ import annotations


def make(cfg, params: dict):
    """(prepare, call): `prepare(batch)` turns one batch of the pool into the
    port's inputs, in set-up; `call(prepared)` solves it and returns the
    forces (B, h, 4, 3) on the device, without waiting for them. A program
    without `solve_sparse_batch` fails here, in set-up."""
    from quadruped_ctrl_tpu_torch.mpc import pipeline, sparse

    solve = sparse.solve_sparse_batch
    kw = dict(weights=cfg.mpc.weights, mu=cfg.mpc.mu, iterations=cfg.solver.iterations,
              polish_rounds=cfg.solver.polish_rounds)

    def prepare(batch: dict):
        return pipeline.MPCInputs(**batch)

    def call(inputs):
        return solve(cfg, inputs, **kw)

    return prepare, call
