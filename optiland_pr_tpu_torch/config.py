"""Numeric configuration of the PyTorch port.

The JAX package picks float64 or float32 from ``jax_enable_x64``. PyTorch has
no such switch, so the port defaults to float64 (the CPU parity tests) and
callers pass ``dtype=torch.float32`` for work on the card. Every builder also
takes an explicit ``device``.
"""
from __future__ import annotations

import torch

__all__ = ["default_float", "set_default_float"]

_DEFAULT_FLOAT: torch.dtype | None = None


def default_float() -> torch.dtype:
    """The dtype for new optical parameters and rays when none is given."""
    return torch.float64 if _DEFAULT_FLOAT is None else _DEFAULT_FLOAT


def set_default_float(dtype) -> None:
    """Override the default float dtype (``None`` restores float64)."""
    global _DEFAULT_FLOAT
    _DEFAULT_FLOAT = dtype
