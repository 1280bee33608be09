"""iterate_idle_ms.robot: `iterate_idle_ms.batch` read in the robot cell,
where it moves `robot_solve_ms_p95` (see `iterate_idle_ms.batch.py`; the
span it reads is `qct.admm.iterate`)."""

from benchmark.harness.spec import metric_reader

read = metric_reader("iterate_idle_ms.batch").read
