"""ADMM QP solver (per-scenario and batched) and the float64 reference IPM."""
