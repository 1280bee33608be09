"""Interpolation primitives (reference Utilities/Interpolation.h:12-67)."""

from __future__ import annotations

import torch


def lerp(y0, yf, x):
    return y0 + (yf - y0) * x


def cubic_bezier(y0, yf, x):
    """y0 -> yf along x in [0,1] (Interpolation.h:29-36)."""
    b = x * x * x + 3.0 * (x * x * (1.0 - x))
    return y0 + b * (yf - y0)


def cubic_bezier_d1(y0, yf, x):
    """d/dx of cubic_bezier (Interpolation.h:43-50)."""
    return 6.0 * x * (1.0 - x) * (yf - y0)


def cubic_bezier_d2(y0, yf, x):
    """d2/dx2 of cubic_bezier (Interpolation.h:57-64)."""
    return (6.0 - 12.0 * x) * (yf - y0)


def deadband(command, min_val, max_val, region=0.075):
    """Stick deadband + range scaling (DesiredStateCommand.cpp:143-149)."""
    return torch.where(command.abs() < region, 0.0, command * 0.5 * (max_val - min_val))
