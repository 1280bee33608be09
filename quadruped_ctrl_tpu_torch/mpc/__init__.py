"""MPC formation and the batched packed pipeline."""
