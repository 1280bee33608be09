"""Leg kinematics."""
