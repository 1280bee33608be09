"""MPC formation and the pipeline: the per-scenario and the batched packed solves."""
