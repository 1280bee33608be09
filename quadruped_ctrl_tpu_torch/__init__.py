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
`sweep`; and the entry points around them: the twins of the JAX package's
`bench.py` and `bench_latency.py` (`bench`, `bench_latency`), scale-out over
`torch.distributed` (`parallel`), the kernel smoke lane
(`utils.kernels_smoke`), the native runtime's C ABI (`runtime.native`), the
PyBullet bridge, the `cli` commands `bench`, `latency`, `kernels-smoke` and
`scaling`, and `graft_entry`.
The configuration tree is the port's own copy (`config.py`); nothing here
imports JAX or the JAX package.
"""

from quadruped_ctrl_tpu_torch.config import FrameworkConfig, default_config  # noqa: F401
