"""Variable scalers (port of ``optiland_pr_tpu/optimize/scaling.py``;
reference optiland/optimization/scaling/).

Every scaler takes a tensor or a Python number (the optimizers scale their
bounds, which are numbers); a number becomes a float64 tensor first.
"""
from __future__ import annotations

import torch

__all__ = ["IdentityScaler", "LinearScaler", "LogScaler", "PowScaler",
           "ReciprocalScaler", "get_scaler"]


def _t(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, dtype=torch.float64)


class IdentityScaler:
    def scale(self, v):
        return v

    def inverse_scale(self, v):
        return v


class LinearScaler:
    def __init__(self, factor: float = 1.0, offset: float = 0.0):
        self.factor = factor
        self.offset = offset

    def scale(self, v):
        return v * self.factor + self.offset

    def inverse_scale(self, v):
        return (v - self.offset) / self.factor


class LogScaler:
    def scale(self, v):
        return torch.log(_t(v))

    def inverse_scale(self, v):
        return torch.exp(_t(v))


class PowScaler:
    def __init__(self, power: float = 2.0):
        self.power = power

    def scale(self, v):
        v = _t(v)
        return torch.sign(v) * torch.abs(v) ** self.power

    def inverse_scale(self, v):
        v = _t(v)
        return torch.sign(v) * torch.abs(v) ** (1.0 / self.power)


class ReciprocalScaler:
    """1/v both ways; IEEE division gives the reference's explicit branches
    (scaling/reciprocal.py: inf -> 0, 0 -> inf)."""

    def scale(self, v):
        return 1.0 / _t(v)

    def inverse_scale(self, v):
        return 1.0 / _t(v)


_SCALERS = {"identity": IdentityScaler, "linear": LinearScaler,
            "log": LogScaler, "pow": PowScaler, "reciprocal": ReciprocalScaler}


def get_scaler(spec):
    if spec is None:
        return IdentityScaler()
    if isinstance(spec, str):
        return _SCALERS[spec]()
    return spec
