"""device_idle_share.robot: `device_idle_share.batch` read in the robot cell,
where it moves `robot_solve_ms_p95` (see `device_idle_share.batch.py`)."""

from benchmark.harness.spec import metric_reader

read = metric_reader("device_idle_share.batch").read
