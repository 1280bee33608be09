"""The comparison fails what it must: the TF32 control in the program's
place, and each fault the cells can have planted under an otherwise
unchanged run. On the CPU at a small size (the harness's look for a card
skipped); with a card, the control at the cells' own sizes."""

import pytest

from benchmark import calibrate
from benchmark import run as bench
from benchmark.harness import control, spec

SMALL = {"h16_full_solve": {"batch": 16, "pool": 2}, "h10_trot_solve": {"batch": 16, "pool": 2},
         "h16_midband_solve": {"batch": 16, "pool": 2}, "h10_robot_solve": {"pool": 12}}
FAULTS = [(cell, fault) for cell in SMALL for fault in control.FAULTS
          if not (fault == "half_batch" and cell == "h10_robot_solve")]  # a batch of one


def run_small(cell, seed, wrap=None, seconds=0.2):
    args = bench.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)])
    result, _, _, _ = bench.run(args, device="cpu", entry_wrap=wrap, traffic_over=SMALL[cell])
    return result


@pytest.mark.parametrize("cell", list(SMALL))
def test_the_program_passes(cell):
    assert run_small(cell, 2 ** 31 + 101)["correct"] is True


@pytest.mark.parametrize("cell", list(SMALL))
def test_the_tf32_control_fails(cell):
    mpc = spec.load_cell(cell).config["mpc"]
    result = run_small(cell, 2 ** 31 + 101, control.tf32_control(mpc), seconds=0.01)
    assert result["correct"] is False


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_each_fault_fails(cell, fault):
    assert run_small(cell, 2 ** 31 + 202, control.FAULTS[fault])["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", list(SMALL))
def test_the_tf32_control_fails_on_the_card_at_the_cells_size(card, cell):
    mpc = spec.load_cell(cell).config["mpc"]
    full = calibrate.full_sample_calls(cell)      # a sample as large as a timed run's
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        args = bench.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0.5"])
        result, _, _, _ = bench.run(args, entry_wrap=control.tf32_control(mpc), min_calls=full)
        assert result["correct"] is False
