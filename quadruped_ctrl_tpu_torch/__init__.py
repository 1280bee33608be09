"""quadruped_ctrl_tpu_torch: the PyTorch / CUDA port of quadruped_ctrl_tpu.

This slice covers the batched packed MPC solve
(`mpc.pipeline.solve_packed_batch`): formation, factorization, ADMM iterate
and polish, with hand-written CUDA kernels for Hopper (sm_90a) in `csrc/`
wherever the JAX package runs a Pallas kernel. The configuration tree is the
JAX package's own (`quadruped_ctrl_tpu.config`, which imports only numpy);
nothing here imports JAX.
"""

from quadruped_ctrl_tpu.config import FrameworkConfig, default_config  # noqa: F401
