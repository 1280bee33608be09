"""The mixed-gait scenario generator: the reference controller's mode-0 gait
library in every batch.

A traffic file names the gaits (each one's offsets and durations in
segments at the horizon, ConvexMPCLocomotion.cpp:23-41, 149-172) and how
many scenarios of each a batch holds (`per_gait`). Each scenario runs its
gait from a segment of its own, drawn uniformly in 0..h-1, and its contact
table is rolled from that segment as OffsetDurationGait::getMpcTable does
(Gait.cpp:142-166); the gaits' positions within a batch are shuffled. Every
other input is drawn as `mpc_scenarios` draws it, from the same traffic
file's ranges and reference columns. Everything is drawn on `device` from
generators seeded with the run's seed: the same seed gives the same pool,
on one kind of device. Imports nothing of the measured program.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch


def _scenarios():
    path = Path(__file__).with_name("mpc_scenarios.py")
    spec = importlib.util.spec_from_file_location("bench_traffic_mpc_scenarios", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roll(offsets, durations, segment, horizon: int) -> torch.Tensor:
    """Contact tables (S, h, 4) of gaits with offsets and durations (S, 4)
    in segments, each from its segment (S,), as Gait.cpp:142-166: step i
    of the table is iteration (i + segment + 1) mod h, and a foot is in
    stance where its progress (iteration - offset, mod h) is under its
    duration."""
    i = torch.arange(horizon, device=offsets.device)[None, :, None]
    it = (i + segment[:, None, None] + 1) % horizon
    progress = it - offsets[:, None, :]
    progress = torch.where(progress < 0, progress + horizon, progress)
    return (progress < durations[:, None, :]).to(torch.float32)


def assign(traffic: dict, horizon: int, seed: int, device) -> tuple:
    """(gait index (pool, batch) into the traffic file's `gaits`, segment
    (pool, batch)): `per_gait` scenarios of each gait a batch, shuffled by
    the seed, each at a segment uniform in 0..h-1."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(seed) + 0x6A17) % 2**63)
    pool, batch = int(traffic["pool"]), int(traffic["batch"])
    n_gaits, per = len(traffic["gaits"]), int(traffic["per_gait"])
    if n_gaits * per != batch:
        raise ValueError(f"{n_gaits} gaits x {per} a gait is not a batch of {batch}")
    order = torch.argsort(torch.rand((pool, batch), generator=gen, device=dev), dim=1)
    index = torch.arange(n_gaits, device=dev).repeat_interleave(per)[order]
    segment = torch.randint(0, horizon, (pool, batch), generator=gen, device=dev)
    return index, segment


def make_pool(traffic: dict, horizon: int, seed: int, device) -> list[dict]:
    """`traffic["pool"]` batches, each a dict of float32 tensors with a
    leading axis of `traffic["batch"]` scenarios: the fields of the port's
    `MPCInputs`, as `mpc_scenarios.make_pool` makes them, each scenario's
    gait table its own."""
    dev = torch.device(device)
    steady = dict(traffic, gait_table=[[1.0] * 4] * horizon)
    pool = _scenarios().make_pool(steady, horizon, seed, dev)
    index, segment = assign(traffic, horizon, seed, dev)
    gaits = list(traffic["gaits"].values())
    offsets = torch.tensor([g["offsets"] for g in gaits], device=dev)
    durations = torch.tensor([g["durations"] for g in gaits], device=dev)
    for k, b in enumerate(pool):
        b["gait_table"] = roll(offsets[index[k]], durations[index[k]], segment[k], horizon)
    return pool
