"""Numeric configuration of the PyTorch port.

The JAX package picks float64 or float32 from ``jax_enable_x64``. PyTorch has
no such switch, so the port defaults to float64 (the CPU parity tests) and
callers pass ``dtype=torch.float32`` for work on the card.

Every builder takes an explicit ``device``; without one it builds on
``default_device()``, the card. A caller that means the CPU says so
(``device="cpu"``); on a machine without a card the default gets torch's own
error, never a silent CPU run.
"""
from __future__ import annotations

import torch

__all__ = ["default_float", "set_default_float", "default_device",
           "resolve_device"]

_DEFAULT_FLOAT: torch.dtype | None = None
_DEFAULT_DEVICE = torch.device("cuda")


def default_float() -> torch.dtype:
    """The dtype for new optical parameters and rays when none is given."""
    return torch.float64 if _DEFAULT_FLOAT is None else _DEFAULT_FLOAT


def set_default_float(dtype) -> None:
    """Override the default float dtype (``None`` restores float64)."""
    global _DEFAULT_FLOAT
    _DEFAULT_FLOAT = dtype


def default_device() -> torch.device:
    """The device builders use when the caller names none: the card."""
    return _DEFAULT_DEVICE


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or ``default_device()`` for None."""
    return default_device() if device is None else torch.device(device)
