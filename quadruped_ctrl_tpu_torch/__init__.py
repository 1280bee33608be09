"""quadruped_ctrl_tpu_torch: the PyTorch / CUDA port of quadruped_ctrl_tpu.

It covers the MPC solve: the batched packed solve
(`mpc.pipeline.solve_packed_batch`) at h=10 and h=16 (formation,
factorization, ADMM iterate and polish) and the per-scenario solve
(`mpc.pipeline.solve`, `solve_compressed` and their vmapped batches), with
hand-written CUDA kernels for Hopper (sm_90a) in `csrc/` wherever the JAX
package runs a Pallas kernel, the batched closed loop that drives it
(`sim.batch_rollout.batch_rollout`: the controller, its estimators and gait,
the SRB simulator), and the single-robot sessions on the SRB and the 18-DoF
articulated simulators (`sim.rollout`, `sim.articulated`, `models`) with the
camera, the stage-wise MPC, checkpoints and the `cli` commands `sim` and
`sweep`.
The configuration tree is the port's own copy (`config.py`); nothing here
imports JAX or the JAX package.
"""

from quadruped_ctrl_tpu_torch.config import FrameworkConfig, default_config  # noqa: F401
