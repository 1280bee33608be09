"""The comparison that decides `correct`.

After the window, a sample of the scenarios the window solved, drawn from
the seed, is solved again by the plain reference (`reference/mpc_qp.py`, in
float64) from the raw inputs, and the forces the timed calls returned are
judged by each scenario's relative cost gap |J(f) - J*| / J*: J the
reference's own cost of the predicted states, J* the optimum's. A wrong
formation, factorization, iterate or polish, forces scattered to the wrong
foot or step, and forces outside the constraints (cheaper than the optimum)
all move it. Every number the cell's file gives a limit is compared
beside it:

* `gap_p50`, `gap_p90`, `gap_p98`: quantiles (nearest rank) of the gaps
  over the sample. Quantiles, not the largest gap: the port's own float32
  solve resolves 1-2% of scenarios, its knife edges, onto a nearby active
  set, which costs up to ~1e-2 of J* there and reads above a TF32 solve's
  worst case; below that tail the port sits at ~1e-8 and a TF32 solve at
  ~1e-5.
* `viol_max_N`: the largest constraint violation over the sample, in N
  (friction pyramid, 0 <= fz <= f_max on stance feet, no force on a swing
  foot): a fault confined to a few scenarios shows here.
* `nonfinite`: scenarios with a non-finite force among every output the run
  kept (an exact comparison, limit 0).

The largest gap is printed beside them, and not compared.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.mpc_qp import FIELDS, Reference, violation

CHUNK = 512


def sample(seed: int, slots: int, batch: int, want: int) -> list[tuple[int, int]]:
    """`want` distinct (slot, scenario) pairs drawn from the seed, spread
    evenly over `slots` kept outputs of `batch` scenarios each (every
    scenario when there are fewer)."""
    rng = np.random.default_rng([int(seed) % 2**63, 0xC0FFEE])
    if slots * batch <= want:
        return [(s, i) for s in range(slots) for i in range(batch)]
    per = max(1, math.ceil(want / slots))
    out = []
    for s in range(slots):
        for i in sorted(rng.choice(batch, size=min(per, batch), replace=False)):
            out.append((s, int(i)))
    return out


def gather(pairs, inputs: list[dict], forces: list[torch.Tensor], device):
    """The sampled scenarios' raw inputs (a dict of tensors) and forces."""
    by_slot = {}
    for s, i in pairs:
        by_slot.setdefault(s, []).append(i)
    inp = {k: [] for k in FIELDS}
    out = []
    for s, idx in by_slot.items():
        ix = torch.tensor(idx, device=forces[s].device)
        for k in FIELDS:
            inp[k].append(inputs[s][k].to(forces[s].device)[ix].to(device))
        out.append(forces[s][ix].to(device))
    return {k: torch.cat(v) for k, v in inp.items()}, torch.cat(out)


def quantile(x: torch.Tensor, q: float) -> float:
    """Nearest-rank quantile of a 1-D tensor; NaN counts as +inf."""
    xs = torch.sort(torch.nan_to_num(x.double(), nan=float("inf"))).values
    return float(xs[max(0, math.ceil(q * len(xs)) - 1)])


def judge(mpc: dict, inp: dict, forces: torch.Tensor, solver=None) -> dict:
    """Per-scenario gaps and violations of forces (S, h, 4, 3) on inputs
    `inp`, and the numbers compared. `solver` (a `Reference` in another
    precision, the control) stands in the program's place when given: the
    forces judged are then its own."""
    ref = Reference(mpc)
    gaps, viols, worst = [], [], dict(dual=0.0, primal=0.0)
    for c0 in range(0, forces.shape[0], CHUNK):
        part = {k: v[c0:c0 + CHUNK] for k, v in inp.items()}
        f_opt, res = ref.solve(part)
        worst = {k: max(worst[k], res[k]) for k in worst}
        f = forces[c0:c0 + CHUNK] if solver is None else solver.solve(part)[0]
        j_opt = ref.cost(part, f_opt)
        gaps.append(((ref.cost(part, f.to(torch.float64)) - j_opt).abs() / j_opt).cpu())
        viols.append(violation(mpc, f, part["gait_table"]).cpu())
    gap, viol = torch.cat(gaps), torch.cat(viols)
    return dict(gap_p50=quantile(gap, 0.5), gap_p90=quantile(gap, 0.9),
                gap_p98=quantile(gap, 0.98), gap_max=quantile(gap, 1.0),
                viol_max_N=quantile(viol, 1.0),
                ref_dual=worst["dual"], ref_primal_N=worst["primal"])


def verdict(numbers: dict, limits: dict, nonfinite: int) -> tuple[bool, dict]:
    """(correct, checks): each number that `limits` names, beside its limit."""
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    checks["nonfinite"] = {"value": nonfinite, "limit": 0}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks
