"""Device mesh + sharding helpers: scenario data parallelism over a process
group.

The counterpart of `quadruped_ctrl_tpu/parallel/mesh.py`, whose
`shard_map` over a ("dp", "mp") device mesh becomes one `torch.distributed`
rank per device: each rank holds its slice of the scenario batch, solves it
where it lies, and the metric reductions are `dist.all_reduce` sums (the
counterpart of the JAX `psum`). The group's backend follows the device:
NCCL for CUDA tensors, Gloo for CPU tensors. NCCL refuses two ranks on one
GPU, so a rank on the card drives `cuda:<rank>` alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import socket

import torch
import torch.distributed as dist

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.config import FrameworkConfig
from quadruped_ctrl_tpu_torch.core.types import tree_map
from quadruped_ctrl_tpu_torch.mpc import pipeline


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("dp", "mp") layout over the ranks of the default process group.
    The scenario batch is sharded over both axes (pure data parallel), so a
    rank's slice is its position in the flattened grid, dp major: rank
    `r` holds rows [r * local, (r + 1) * local) of the global batch."""

    shape: dict                 # {"dp": n // mp, "mp": mp}
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["mp"]


def backend_for(dev) -> str:
    """The process-group backend for tensors on `dev`: "nccl" on a CUDA
    device, "gloo" on the CPU."""
    return "nccl" if torch.device(dev).type == "cuda" else "gloo"


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def local_group(device=None):
    """A one-rank process group on `device` (cuda:0 unless named: NCCL;
    the CPU: Gloo) for the block, on a free localhost port, destroyed on
    exit; the group already initialised, unchanged, when there is one."""
    dev = _device.resolve(device)
    if dist.is_initialized():
        yield dev
        return
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def make_mesh(n_devices: int | None = None, mp: int = 1, device=None) -> Mesh:
    """A ("dp","mp") mesh over the ranks of the initialised process group,
    this process driving `device` (cuda:<rank> unless named; "cpu" for a
    Gloo group on the CPU). n_devices defaults to the world size and must
    equal it. mp=1 keeps all ranks on the data axis; mp>1 reserves an axis
    for model-style sharding."""
    if device is None:
        _device.resolve()                       # raises without a card
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "multihost.initialize_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh: {n} devices asked for, the group has {world} ranks "
                         "(one rank drives one device)")
    if n % mp:
        raise ValueError(f"make_mesh: {n} devices do not split into mp={mp}")
    dev = torch.device("cuda", rank) if device is None else torch.device(device)
    want = backend_for(dev)
    if dist.get_backend() != want:
        raise ValueError(f"make_mesh: a {dist.get_backend()} group cannot carry tensors "
                         f"on {dev}; it needs {want}")
    return Mesh({"dp": n // mp, "mp": mp}, rank, dev)


def batch_sharding(mesh: Mesh) -> tuple[int, int]:
    """The scenario batch sharded across BOTH mesh axes (pure data
    parallel): (this rank's shard index, the number of shards)."""
    return mesh.rank, mesh.size


def shard_batch(tree, mesh: Mesh):
    """This rank's slice of every leaf's leading (batch) axis, on the
    mesh's device."""
    index, shards = batch_sharding(mesh)

    def local(x):
        if x.shape[0] % shards:
            raise ValueError(f"shard_batch: batch {x.shape[0]} does not split into "
                             f"{shards} shards")
        per = x.shape[0] // shards
        return x[index * per:(index + 1) * per].to(mesh.device).contiguous()

    return tree_map(local, tree)


def sharded_mpc_solve(cfg: FrameworkConfig, mesh: Mesh, h: int,
                      iterations: int | None = None, packed: bool = True,
                      max_stance: int = 2):
    """Returns a function: this rank's MPCInputs shard -> (its forces, the
    global mean |f|).

    Forces stay local; the statistic (sum |f| and the count) is all-reduced
    over every rank. With `packed` (default) each shard solves through the
    stance-compressed pair-packed fast path (pipeline.solve_packed_batch:
    kernels K1 and K2 on the card); gait tables must then have <=
    max_stance stance feet per step (raise it for non-trot gaits), and odd
    per-shard batches fall back to the per-scenario vmap path (the
    differential reference, any gait)."""

    def local(inp: pipeline.MPCInputs):
        if packed and inp.rpy.shape[0] % 2 == 0:
            forces = pipeline.solve_packed_batch(
                cfg, inp, max_stance=max_stance, iterations=iterations)
        else:
            forces = pipeline.solve_batch(cfg, inp, iterations=iterations)
        stats = torch.stack([forces.abs().sum(),
                             torch.tensor(float(forces.numel()), device=forces.device)])
        dist.all_reduce(stats)
        return forces, stats[0] / stats[1]

    return local
