"""Entry: the port's batched single-launch MPC solve,
`mpc/pipeline.solve_packed_batch(use_fused=True)` (kernel K5 on the card),
one call per batch of scenarios."""

from __future__ import annotations


def make(cfg, params: dict):
    """(prepare, call): `prepare(batch)` turns one batch of the pool into the
    port's inputs, in set-up; `call(prepared)` solves it and returns the
    forces (B, h, 4, 3) on the device, without waiting for them."""
    from quadruped_ctrl_tpu_torch.mpc import pipeline

    max_stance = int(params["max_stance"])

    def prepare(batch: dict):
        return pipeline.MPCInputs(**batch)

    def call(inputs):
        return pipeline.solve_packed_batch(cfg, inputs, max_stance=max_stance, use_fused=True)

    return prepare, call
