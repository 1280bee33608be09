"""The scenario generator every traffic file of this benchmark names.

A traffic file gives the scenarios' distributions: a uniform range for each
component of each input (the port's `mpc/pipeline.random_inputs`, the JCQP
ProblemGenerator pattern), the reference trajectory's columns (a constant or
a copy of an input component), and the gait table every scenario runs.
`pool` batches of `batch` scenarios are drawn in a few large calls
on `device` from a generator seeded with the run's seed: the same seed
gives the same pool, on one kind of device.
"""

from __future__ import annotations

import torch

INPUTS = ("rpy", "position", "omega_world", "v_world", "r_feet", "x_drag")


def make_pool(traffic: dict, horizon: int, seed: int, device) -> list[dict]:
    """`traffic["pool"]` batches, each a dict of float32 tensors with a
    leading axis of `traffic["batch"]` scenarios: the fields of the port's
    `MPCInputs` (rpy, position, omega_world, v_world (3,), r_feet (4, 3),
    traj (h, 13), gait_table (h, 4), x_drag ())."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**63)
    pool, batch = int(traffic["pool"]), int(traffic["batch"])
    total = pool * batch
    out = {}
    for name in INPUTS:
        rng = torch.tensor(traffic["ranges"][name], dtype=torch.float32, device=dev)
        lo, hi = rng[:, 0], rng[:, 1]
        draw = torch.rand((total, 4 if name == "r_feet" else 1, rng.shape[0]),
                          generator=gen, device=dev)
        out[name] = lo + (hi - lo) * draw
    for name in ("rpy", "position", "omega_world", "v_world"):
        out[name] = out[name][:, 0]
    out["x_drag"] = out["x_drag"][:, 0, 0]

    traj = torch.zeros((total, horizon, 13), dtype=torch.float32, device=dev)
    for col, src in traffic["traj"].items():
        if isinstance(src, str):
            field, comp = src.split(".")
            traj[:, :, int(col)] = out[field][:, int(comp), None]
        else:
            traj[:, :, int(col)] = float(src)
    out["traj"] = traj

    table = torch.tensor(traffic["gait_table"], dtype=torch.float32, device=dev)
    if table.shape != (horizon, 4):
        raise ValueError(f"gait table {tuple(table.shape)}, horizon {horizon}")
    out["gait_table"] = table.expand(total, horizon, 4).contiguous()
    return [{k: v[i * batch:(i + 1) * batch] for k, v in out.items()} for i in range(pool)]

