"""Multi-process throughput worker (launched by multihost's scaling
harnesses).

Each process is one rank of a `torch.distributed` group and drives one
device; all ranks run the same sharded fast-path MPC solve over the global
batch (Gloo collectives on the CPU, NCCL on cuda:<pid>). The process's
share of the batch is `devs_per_proc * per_device_batch` scenarios. A CPU
rank runs its torch ops on one thread. Process 0 writes {"solves_per_s",
"rel_iqr", "samples"} to the output path.

Usage: python -m quadruped_ctrl_tpu_torch.parallel._throughput_worker \
           <pid> <nproc> <port> <devs_per_proc> <per_device_batch> <reps> <out> \
           [<device type: cpu | cuda> [<horizon>]]
"""

import json
import sys
import time


def main():
    pid, nproc, port, devs, pdb, reps = (int(a) for a in sys.argv[1:7])
    out_path = sys.argv[7]
    device_type = sys.argv[8] if len(sys.argv) > 8 else "cpu"
    h = int(sys.argv[9]) if len(sys.argv) > 9 else 10

    import numpy as np
    import torch
    import torch.distributed as dist

    from quadruped_ctrl_tpu_torch.config import default_config
    from quadruped_ctrl_tpu_torch.mpc import pipeline
    from quadruped_ctrl_tpu_torch.parallel import mesh as mesh_mod
    from quadruped_ctrl_tpu_torch.parallel.multihost import initialize_distributed

    dev = torch.device("cuda", pid) if device_type == "cuda" else torch.device("cpu")
    if dev.type == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", nproc, pid, device=dev)
    try:
        cfg = default_config()
        batch = nproc * devs * pdb
        mesh = mesh_mod.make_mesh(nproc, device=dev)
        # every process builds the same global batch, then keeps its slice
        inputs = mesh_mod.shard_batch(pipeline.random_inputs(0, batch, h, device=dev), mesh)
        fn = mesh_mod.sharded_mpc_solve(cfg, mesh, h)
        float(fn(inputs)[1])                 # warm up; the all-reduce is a barrier
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(fn(inputs)[1])
            samples.append(batch / (time.perf_counter() - t0))
    finally:
        dist.destroy_process_group()
    if pid == 0:
        med = float(np.median(samples))
        iqr = float(np.percentile(samples, 75) - np.percentile(samples, 25))
        with open(out_path, "w") as f:
            json.dump({"solves_per_s": med,
                       "rel_iqr": iqr / max(med, 1e-12),
                       "samples": samples}, f)


if __name__ == "__main__":
    main()
