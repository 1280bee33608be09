"""solve_syncs_per_call.robot: `solve_syncs_per_call.batch` read in the robot
cell, where it moves `robot_solve_ms_p95` (see
`solve_syncs_per_call.batch.py`; the span it reads is `qct.solve`)."""

from benchmark.harness.spec import metric_reader

read = metric_reader("solve_syncs_per_call.batch").read
