"""Host-side inspection of builder inputs (port of
``optiland_pr_tpu/utils/hostvals.py``).

Static structure (is a radius infinite?) is read from what the user typed,
Python numbers and numpy arrays, so that computing the kernel's flags never
waits on the device. A tensor on the card is read back only when a caller
hands one in.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["host_isinf"]


def host_isinf(value, default: bool = False) -> bool:
    """True if ``value`` is +-inf; ``default`` when it cannot be told."""
    if value is None:
        return default
    if isinstance(value, (int, float)):
        return math.isinf(value)
    if isinstance(value, (np.ndarray, np.generic)):
        return bool(np.isinf(value))
    if isinstance(value, torch.Tensor):
        return bool(torch.isinf(value.detach()).item())
    try:
        return bool(np.isinf(np.asarray(value)))
    except (TypeError, ValueError):
        return default
