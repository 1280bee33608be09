"""The control and the planted faults: entries that stand in the program's
place, for `run.run(..., entry_wrap=...)`.

`tf32_control(mpc)` puts the plain reference, computed in TF32 (the
precision below the configuration's float32), in the program's place; the
comparison must read it as not correct. The faults break the program's
timed path underneath an otherwise unchanged run:

* `unchanged`: the solve returns its state unchanged (the cold start: zero
  forces);
* `half_batch`: only the first half of each batch is solved, the second
  half gets the mean of the first half's forces;
* `altered`: every answer altered where it is produced (5 N more on the
  first stance foot's fz at the first step);
* `swing_force`: a few answers altered: one scenario in 32 of each batch
  (every request of a batch of one) gets 5 N of fz on its first swing foot,
  a force the gait forbids; the gaps' quantiles do not see so few.
"""

from __future__ import annotations

import torch

from benchmark.reference.mpc_qp import FIELDS, Reference


def _raw(prepared) -> dict:
    d = {k: getattr(prepared, k) for k in FIELDS}
    return {k: v[None] for k, v in d.items()} if d["traj"].dim() == 2 else d


def tf32_control(mpc: dict):
    ref = Reference(mpc, "tf32")

    def wrap(call):
        def control(prepared):
            return ref.solve(_raw(prepared))[0].float()
        return control
    return wrap


def unchanged(call):
    def fault(prepared):
        return torch.zeros_like(call(prepared))
    return fault


def half_batch(call):
    def fault(prepared):
        f = call(prepared)
        half = f.shape[0] // 2
        out = f.clone()
        out[half:] = f[:max(half, 1)].mean(0)
        return out
    return fault


def altered(call):
    def fault(prepared):
        f = call(prepared).clone()
        gait = _raw(prepared)["gait_table"]
        first = (gait[:, 0] > 0.5).float().argmax(1)
        f[torch.arange(f.shape[0]), 0, first, 2] += 5.0
        return f
    return fault


def swing_force(call):
    def fault(prepared):
        f = call(prepared).clone()
        swing = (_raw(prepared)["gait_table"] < 0.5).flatten(1)
        first = swing.float().argmax(1)
        few = torch.arange(0, f.shape[0], 32, device=f.device)
        f.view(f.shape[0], -1, 3)[few, first[few], 2] += 5.0 * swing[few, first[few]]
        return f
    return fault


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered,
          "swing_force": swing_force}
