"""Host-side utilities: timers, metrics, checkpoints."""
