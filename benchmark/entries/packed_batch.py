"""Entry: the port's batched, stance-compressed, pair-packed MPC solve,
`mpc/pipeline.solve_packed_batch`, one call per batch of scenarios."""

from __future__ import annotations


def make(cfg, params: dict):
    """(prepare, call): `prepare(batch)` turns one batch of the pool into the
    port's inputs, in set-up; `call(prepared)` solves it and returns the
    forces (B, h, 4, 3) on the device, without waiting for them."""
    from quadruped_ctrl_tpu_torch.mpc import pipeline

    max_stance, pack = int(params["max_stance"]), int(params["pack"])

    def prepare(batch: dict):
        return pipeline.MPCInputs(**batch)

    def call(inputs):
        return pipeline.solve_packed_batch(cfg, inputs, max_stance=max_stance, pack=pack)

    return prepare, call
