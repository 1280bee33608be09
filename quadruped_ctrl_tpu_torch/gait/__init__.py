"""Gait scheduling."""
