"""Entry: one robot's cold MPC solve, the port's `mpc/pipeline.solve`
(unbatched, uncompressed, plain torch: the single-robot controller's MPC
tick), one call per scenario."""

from __future__ import annotations


def make(cfg, params: dict):
    """(prepare, call): `prepare(batch)` turns one pool entry (a batch of one
    scenario) into the port's unbatched inputs, in set-up; `call(prepared)`
    solves it and returns the forces (1, h, 4, 3) on the device."""
    from quadruped_ctrl_tpu_torch.mpc import pipeline

    def prepare(batch: dict):
        return pipeline.MPCInputs(**{k: v[0] for k, v in batch.items()})

    def call(inp):
        return pipeline.solve(cfg, inp)[None]

    return prepare, call
