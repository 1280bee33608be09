"""launches_per_call.robot: `launches_per_call.batch` read in the robot cell,
where it moves `robot_solve_ms_p95` (see `launches_per_call.batch.py`)."""

from benchmark.harness.spec import metric_reader

read = metric_reader("launches_per_call.batch").read
