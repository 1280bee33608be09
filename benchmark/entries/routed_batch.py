"""Entry: the port's batched solve of scenarios with gait tables of their
own, `mpc/pipeline.solve_routed_batch` (each scenario at its own count of
stance variables, the batch grouped by it), one call per batch of
scenarios."""

from __future__ import annotations


def make(cfg, params: dict):
    """(prepare, call): `prepare(batch)` turns one batch of the pool into the
    port's inputs, in set-up; `call(prepared)` solves it and returns the
    forces (B, h, 4, 3) on the device, without waiting for them. A program
    without `solve_routed_batch` fails here, in set-up."""
    from quadruped_ctrl_tpu_torch.mpc import pipeline

    solve = pipeline.solve_routed_batch

    def prepare(batch: dict):
        return pipeline.MPCInputs(**batch)

    def call(inputs):
        return solve(cfg, inputs)

    return prepare, call
