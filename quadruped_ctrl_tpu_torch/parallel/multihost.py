"""Multi-process runtime + scaling-efficiency reporting.

The counterpart of `quadruped_ctrl_tpu/parallel/multihost.py`:
`torch.distributed` bring-up for same-program data parallelism across
processes (one rank per device), and a scaling report measuring
batched-MPC throughput at increasing device counts (the ">=85% efficiency
at 2 hosts" BASELINE.md metric). A device count above 1 runs as a group of
launched worker processes (`_throughput_worker`), one rank each; the
collectives are NCCL on the card and Gloo on the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import FrameworkConfig
from quadruped_ctrl_tpu_torch.mpc import pipeline
from quadruped_ctrl_tpu_torch.parallel import mesh as mesh_mod

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None):
    """Bring up the process group (no-op for single-process runs).

    `coordinator_address` is host:port of rank 0's TCP store. The backend
    follows `device`, this rank's device: NCCL on cuda:<process_id> (the
    default), Gloo when `device` is the CPU. Returns whether a group was
    initialised."""
    if num_processes is None and coordinator_address is None:
        return False  # single process
    if device is None:
        _device.resolve()                       # raises without a card
        dev = torch.device("cuda", process_id)
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(mesh_mod.backend_for(dev),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def _launch_group(nproc: int, devs: int, per_device_batch: int, reps: int, h: int,
                  device_type: str, timeout_s: float) -> dict:
    """Run `_throughput_worker` in nproc processes, one rank each, and
    return rank 0's report. Every process is stopped before this returns."""
    port = mesh_mod.free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "tput.json")
        procs = []
        try:
            for pid in range(nproc):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "quadruped_ctrl_tpu_torch.parallel._throughput_worker",
                     str(pid), str(nproc), str(port), str(devs), str(per_device_batch),
                     str(reps), out, device_type, str(h)],
                    cwd=_REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                    text=True))
            deadline = time.monotonic() + timeout_s
            for p in procs:
                _, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
                if p.returncode != 0:
                    raise RuntimeError(f"worker exited {p.returncode} (nproc={nproc}): "
                                       f"{err[-2000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        with open(out) as f:
            return json.load(f)


def _throughput(cfg: FrameworkConfig, n_devices: int, per_device_batch: int,
                h: int, reps: int, device=None):
    """Per-rep solves/s samples for a batch sharded over n_devices ranks,
    one device each. Returns a list of `reps` independent measurements so
    callers can report medians and spread. One device runs here, on a
    one-rank group; more run as launched worker processes."""
    dev = _device.resolve(device)
    batch = n_devices * per_device_batch
    if n_devices > 1:
        return _launch_group(n_devices, 1, per_device_batch, reps, h, dev.type,
                             timeout_s=540.0)["samples"]
    with mesh_mod.local_group(dev):
        m = mesh_mod.make_mesh(n_devices, device=dev)
        inputs = mesh_mod.shard_batch(pipeline.random_inputs(0, batch, h, device=dev), m)
        fn = mesh_mod.sharded_mpc_solve(cfg, m, h)
        float(fn(inputs)[1])                # warm up (the host reads the mean)
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(fn(inputs)[1])
            samples.append(batch / (time.perf_counter() - t0))
    return samples


def _median_spread(samples):
    med = float(np.median(samples))
    return med, float((np.percentile(samples, 75)
                       - np.percentile(samples, 25)) / max(med, 1e-12))


def multiprocess_scaling(num_processes: int = 2, devs_per_proc: int = 2,
                         per_device_batch: int = 64, reps: int = 3,
                         timeout_s: float = 540.0) -> dict:
    """N-process weak-scaling efficiency with real `torch.distributed` CPU
    processes (Gloo collectives: the cluster-free multi-host harness, as
    the JAX function is). Launches 1-process and N-process runs of the same
    sharded fast-path program over the same global batch and reports
    throughput + efficiency. One rank drives one device, so a process here
    stands for `devs_per_proc` of the JAX harness's virtual devices: its
    share of the batch is devs_per_proc * per_device_batch scenarios."""
    # Same GLOBAL batch both times; only the process split differs. On this
    # shared-core CPU harness that isolates the cross-process collective
    # overhead (the DCN-role cost).
    def run_group(nproc: int, devs: int):
        d = _launch_group(nproc, devs, per_device_batch, reps, 10, "cpu", timeout_s)
        return d["solves_per_s"], d.get("rel_iqr", 0.0)

    t1, s1 = run_group(1, num_processes * devs_per_proc)
    tn, sn = run_group(num_processes, devs_per_proc)
    eff = tn / t1
    rep = {
        "processes": num_processes,
        "devices_per_process": devs_per_proc,
        "global_devices": num_processes * devs_per_proc,
        "solves_per_s_single_process": round(t1, 1),
        "solves_per_s_multi_process": round(tn, 1),
        "rel_iqr": round(max(s1, sn), 4),
        "statistic": "median of per-rep timings (workers report samples)",
        "cross_process_efficiency": round(eff, 4),
        "backend": "cpu",
    }
    if eff > 1.05:
        # splitting the same work over more processes cannot genuinely beat
        # the single process on shared cores: flag as measurement noise
        rep["noise"] = True
    return rep


def scaling_report(cfg: FrameworkConfig, device_counts=None,
                   per_device_batch: int = 256, h: int = 10,
                   reps: int = 10, device=None) -> dict:
    """Scaling report across device counts, on `device` (cuda:0 unless
    named; the counts default to the visible CUDA devices, 1 on the CPU).

    Two efficiencies per row:
    * `sharding_efficiency` — throughput of the batch sharded over n ranks
      vs the SAME total batch on one. This isolates the partitioning +
      collective overhead.
    * `weak_efficiency` — throughput(n) / (n * throughput(1)) at fixed
      per-device batch: the BASELINE.md ">=85% at 2 hosts" number. Only
      meaningful when the devices are real cards; on the CPU every rank
      shares the host's cores (`shared_core_virtual_devices`).

    Statistics: every throughput is the MEDIAN of `reps` independent
    timings (host clock around a solve that ends in the host reading the
    reduced mean), each row carries the relative interquartile spread of
    its samples, and any efficiency > 1.05 is flagged `noise: true`.
    """
    dev = _device.resolve(device)
    n_avail = torch.cuda.device_count() if dev.type == "cuda" else 1
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
    base = None
    rows = []
    for n in device_counts:
        tput, spread = _median_spread(
            _throughput(cfg, n, per_device_batch, h, reps, device=dev))
        if n == 1:
            tput_1dev, spread_1 = tput, spread
        else:
            tput_1dev, spread_1 = _median_spread(
                _throughput(cfg, 1, n * per_device_batch, h, reps, device=dev))
        if base is None:
            base = tput
        sh_eff = tput / tput_1dev
        row = {
            "devices": n,
            "solves_per_s": round(tput, 1),
            "rel_iqr": round(max(spread, spread_1), 4),
            "sharding_efficiency": round(sh_eff, 4),
            "weak_efficiency": round(tput / (base * n), 4),
        }
        if sh_eff > 1.05:
            row["noise"] = True
        rows.append(row)
    return {
        "metric": "mpc_scaling",
        "backend": dev.type,
        "process_group_backend": mesh_mod.backend_for(dev),
        "shared_core_virtual_devices": dev.type == "cpu",
        "per_device_batch": per_device_batch,
        "reps": reps,
        "statistic": "median of reps; rel_iqr = IQR/median",
        "horizon": h,
        "rows": rows,
    }
