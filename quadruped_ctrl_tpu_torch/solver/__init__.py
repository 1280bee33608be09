"""Batched ADMM QP solver."""
