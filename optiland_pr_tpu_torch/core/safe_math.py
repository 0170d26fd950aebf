"""NaN-safe math primitives (port of ``optiland_pr_tpu/core/safe_math.py``).

Every guarded sqrt substitutes its argument where it is invalid before the
sqrt and selects the result after it (the double ``where``), so autograd never
sees an infinite partial in a discarded branch.
"""
from __future__ import annotations

import torch

__all__ = ["safe_sqrt", "safe_div", "nan_sqrt", "TINY"]

TINY = 1e-14


def safe_sqrt(x):
    """sqrt clamped at zero, with an exactly-zero gradient there."""
    ok = x > 0
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), 0.0)


def nan_sqrt(x):
    """sqrt that returns NaN for negative inputs but never poisons gradients."""
    ok = x >= 0
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), torch.nan)


def safe_div(num, den, eps: float = TINY):
    """num/den with |den| clamped away from zero, keeping its sign."""
    mag = torch.clamp(torch.abs(den), min=eps)
    den_safe = torch.where(den < 0, -mag, mag)
    return num / den_safe
