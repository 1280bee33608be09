"""The plain QP reference against the port's plain (CPU) branch at small
batches: the same QP, and the same optimum up to the port's float32 solve.
The tests call the port; the reference does not."""

import pytest
import torch

from benchmark.harness import spec
from benchmark.reference.mpc_qp import FIELDS, Reference, tf32_round, violation


def scenarios(cell: str, seed: int, batch: int):
    c = spec.load_cell(cell)
    traffic = dict(c.traffic, batch=batch, pool=1)
    return c, c.generator().make_pool(traffic, int(c.config["horizon"]), seed, "cpu")[0]


@pytest.mark.parametrize("cell", ["h10_trot_solve", "h16_full_solve"])
def test_qp_equals_the_ports_condensed_qp(cell):
    from quadruped_ctrl_tpu_torch.mpc import formation, pipeline

    c, b = scenarios(cell, 7, 3)
    cfg = spec.program_config(c.config)
    hess, grad, _, _ = Reference(c.config["mpc"]).qp(b)
    for s in range(3):
        inp = pipeline.MPCInputs(**{k: b[k][s] for k in FIELDS})
        adt, bdt, x0 = pipeline._dynamics(cfg, inp)
        h_p, g_p = formation.qp_cost_nil(cfg.mpc, adt, bdt, x0, inp.traj,
                                         torch.ones(inp.traj.shape[0]))
        scale = hess[s].abs().max()
        assert (h_p.double() - hess[s]).abs().max() < 1e-5 * scale
        assert (g_p.double() - grad[s]).abs().max() < 1e-5 * grad[s].abs().max()


@pytest.mark.parametrize("cell,seed", [("h10_trot_solve", 3), ("h16_full_solve", 3),
                                       ("h16_midband_solve", 4)])
def test_optimum_agrees_with_the_ports_plain_solve(cell, seed):
    c, b = scenarios(cell, seed, 16)
    cfg = spec.program_config(c.config)
    prepare, call = c.entry_module().make(cfg, c.workload["params"])
    forces = call(prepare(b))
    ref = Reference(c.config["mpc"])
    f_opt, res = ref.solve(b)
    assert res["primal"] < 1e-6 and res["gap"] < 1e-9 and res["dual"] < 1e-5
    j_opt = ref.cost(b, f_opt)
    gap = (ref.cost(b, forces) - j_opt).abs() / j_opt
    assert gap.median() < 1e-6
    close = ((forces.double() - f_opt).abs().flatten(1).amax(1) < 0.5).double().mean()
    assert close >= 0.9
    assert violation(c.config["mpc"], f_opt, b["gait_table"]).max() < 1e-6
    # swing feet carry exactly nothing
    assert (f_opt[b["gait_table"] < 0.5] == 0).all()


def test_control_is_tf32():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, 3.0], dtype=torch.float32)
    assert tf32_round(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 3.0]
    c, b = scenarios("h10_trot_solve", 3, 8)
    ref, ctl = Reference(c.config["mpc"]), Reference(c.config["mpc"], "tf32")
    f_opt, _ = ref.solve(b)
    f_ctl, _ = ctl.solve(b)
    j_opt = ref.cost(b, f_opt)
    gap = ((ref.cost(b, f_ctl) - j_opt).abs() / j_opt)
    assert f_ctl.dtype == torch.float32 and gap.median() > 1e-7
