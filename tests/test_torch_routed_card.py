"""K1 with the slots' steps (`csrc/formation_pack.cu` through
`ops/formation_pack.form_packed`) and the routed solve
(`mpc/pipeline.solve_routed_batch`) on the card, on the traffic and
configurations of the benchmark's cells, drawn as `benchmark/run.py` draws
them. The `card` tests skip without a card. This file imports no JAX, so
they run where JAX is absent:

    python3 -m pytest --noconftest -p no:cacheprovider -q -m card tests/test_torch_routed_card.py

What is compared, and why so:
- K1 against its plain version `form_packed_reference`, within K1's own
  gates (`chip_smoke.check_k1`: rel_H < 5e-5, the bf16x3 Gram summed in
  another order; rel_g < 1e-5, fp32 in another order), on the per-step
  layout of the three cells that run it (one slot list for every
  scenario) and on `h14_gait_mix_solve`'s stance slot lists at each of its
  four widths (each scenario's own steps);
- the per-step layout given as one list a scenario, bit for bit the one
  list for all (the kernel reads a step a column either way);
- the routed solve of one `h14_gait_mix_solve` batch `correct` under the
  cell's limits, zero on every swing foot; a permuted batch's forces the
  forces permuted, bit for bit; a trot-only batch bit for bit
  `solve_packed_batch(max_stance=2, pack=1)`, whose columns it has.
"""

import pytest
import torch

from benchmark.harness import check, spec
from quadruped_ctrl_tpu_torch.mpc import formation, pipeline
from quadruped_ctrl_tpu_torch.ops import formation_pack as FP

SEED = 25_000_000_014
PER_STEP = ("h16_full_solve", "h10_trot_solve", "h16_midband_solve")
ROUTED = "h14_gait_mix_solve"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """`tests/test_torch_package.py`'s fixture of the same name, defined here
    (the card's machine may hide that module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on one")
    return torch.device("cuda", 0)


def _batch(cell_name: str, dev):
    cell = spec.load_cell(cell_name)
    cfg = spec.program_config(cell.config)
    pool = cell.generator().make_pool(dict(cell.traffic, pool=1), int(cell.config["horizon"]),
                                      SEED, dev)
    return cell, cfg, pipeline.MPCInputs(**pool[0])


def _operands(cfg, inp, sel):
    adt, bdt = formation.srb_discrete(cfg.mpc, inp.r_feet, inp.rpy[:, 2], inp.x_drag,
                                      cfg.dt_mpc)
    x0 = formation.build_x0(inp.rpy, inp.position, inp.omega_world, inp.v_world,
                            cfg.mpc.gravity)
    mask = torch.ones(inp.traj.shape[:2], device=adt.device)
    return formation.packed_qp_operands(cfg.mpc, adt, bdt, x0, inp.traj, mask, sel)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.card
@pytest.mark.parametrize("cell_name", PER_STEP)
def test_k1_per_step_layout(cell_name):
    dev = _card()
    cell, cfg, inp = _batch(cell_name, dev)
    p = cell.workload["params"]
    ms, pack, h = int(p["max_stance"]), int(p["pack"]), inp.traj.shape[1]
    _, _, sel = formation.stance_selectors(inp.gait_table, ms)
    ops = _operands(cfg, inp, sel)
    alpha = float(cfg.mpc.alpha)
    hk, gk = FP.form_packed(*ops, h, ms, pack, alpha)
    hr, gr = FP.form_packed_reference(*ops, h, ms, pack, alpha)
    assert _rel(hk, hr) < 5e-5 and _rel(gk, gr) < 1e-5
    each = FP.per_step_slots(h, ms, dev).expand(inp.traj.shape[0], -1).contiguous()
    hs, gs = FP.form_packed(*ops, h, None, pack, alpha, slot_step=each)
    assert torch.equal(hs, hk) and torch.equal(gs, gk)


@pytest.mark.card
def test_k1_stance_slot_lists_at_each_width():
    dev = _card()
    _, cfg, inp = _batch(ROUTED, dev)
    h = inp.traj.shape[1]
    n = (3 * inp.gait_table.sum((1, 2))).long()
    assert sorted(set(n.tolist())) == [72, 84, 120, 168]
    alpha = float(cfg.mpc.alpha)
    for width in (72, 84, 120, 168):
        idx = torch.nonzero(n == width).flatten()
        sub = pipeline.MPCInputs(**{k: getattr(inp, k)[idx] for k in check.FIELDS})
        _, _, sel, steps = formation.stance_slots(sub.gait_table, width // 3)
        ops = _operands(cfg, sub, sel)
        hk, gk = FP.form_packed(*ops, h, None, 1, alpha, slot_step=steps)
        hr, gr = FP.form_packed_reference(*ops, h, None, 1, alpha, slot_step=steps)
        assert _rel(hk, hr) < 5e-5 and _rel(gk, gr) < 1e-5, width


@pytest.fixture(scope="module")
def routed():
    dev = _card()
    cell, cfg, inp = _batch(ROUTED, dev)
    return cell, cfg, inp, pipeline.solve_routed_batch(cfg, inp)


@pytest.mark.card
def test_routed_solve_is_correct(routed):
    cell, _, inp, forces = routed
    pairs = check.sample(SEED, 1, forces.shape[0], int(cell.workload["check"]["scenarios"]))
    raw = {k: getattr(inp, k) for k in check.FIELDS}
    sample, f = check.gather(pairs, [raw], [forces], forces.device)
    numbers = check.judge(cell.config["mpc"], sample, f)
    nonfinite = int((~torch.isfinite(forces)).flatten(1).any(1).sum())
    correct, checks = check.verdict(numbers, cell.workload["check"]["limits"], nonfinite)
    assert correct, checks
    assert float(forces[inp.gait_table < 0.5].abs().max()) == 0.0


@pytest.mark.card
def test_routed_permuted_batch(routed):
    _, cfg, inp, forces = routed
    perm = torch.randperm(forces.shape[0], generator=torch.Generator().manual_seed(4))
    perm = perm.to(forces.device)
    moved = pipeline.MPCInputs(**{k: getattr(inp, k)[perm] for k in check.FIELDS})
    assert torch.equal(pipeline.solve_routed_batch(cfg, moved), forces[perm])


@pytest.mark.card
def test_routed_trot_only_batch_is_the_packed_solve():
    dev = _card()
    _, cfg, inp = _batch(ROUTED, dev)
    trot = (3 * inp.gait_table.sum((1, 2)) == 84) & (inp.gait_table.sum(-1) == 2).all(-1)
    idx = torch.nonzero(trot).flatten()
    sub = pipeline.MPCInputs(**{k: getattr(inp, k)[idx] for k in check.FIELDS})
    want = pipeline.solve_packed_batch(cfg, sub, max_stance=2, pack=1)
    assert torch.equal(pipeline.solve_routed_batch(cfg, sub), want)
