"""Even and odd aspheres (port of the matching part of
``optiland_pr_tpu/geometry/aspheres.py``): a conic base plus a polynomial in
r^2 or r, intersected by ``newton_distance``.

The number of terms is static (fixed at build); the coefficient values live
in the parameter tree as one tensor, so merit gradients flow through them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.safe_math import safe_div
from .base import Geometry
from .standard import _conic_sag, _conic_sag_grad

__all__ = ["EvenAsphere", "OddAsphere"]


def _coefficients(values, n: int) -> np.ndarray:
    """``values`` as a float64 array zero-padded (or cut) to ``n`` terms."""
    out = np.zeros(n, np.float64)
    v = np.asarray(values if values is not None else [], np.float64)[:n]
    out[:v.shape[0]] = v
    return out


class EvenAsphere(Geometry):
    """z = conic + sum_i C_i r^(2i), i = 1..num_terms."""

    kind = "even_asphere"

    def __init__(self, num_terms: int):
        self.num_terms = int(num_terms)

    def default_params(self, radius=math.inf, conic=0.0, coefficients=None,
                       **kw) -> dict:
        return {"radius": float(radius), "conic": float(conic),
                "coefficients": _coefficients(coefficients, self.num_terms)}

    def sag(self, p, x, y):
        r2 = x**2 + y**2
        z = _conic_sag(p["radius"], p["conic"], x, y)
        c = p["coefficients"]
        term = r2
        for i in range(self.num_terms):
            z = z + c[i] * term
            term = term * r2
        return z

    def sag_grad(self, p, x, y):
        r2 = x**2 + y**2
        dfdx, dfdy = _conic_sag_grad(p["radius"], p["conic"], x, y)
        c = p["coefficients"]
        # d(r^2i)/dx = 2i x r^(2(i-1))
        term = torch.ones_like(r2)
        for i in range(self.num_terms):
            k = 2.0 * (i + 1)
            dfdx = dfdx + k * x * c[i] * term
            dfdy = dfdy + k * y * c[i] * term
            term = term * r2
        return dfdx, dfdy


class OddAsphere(Geometry):
    """z = conic + sum_i C_i r^i, i = 1..num_terms."""

    kind = "odd_asphere"

    def __init__(self, num_terms: int):
        self.num_terms = int(num_terms)

    def default_params(self, radius=math.inf, conic=0.0, coefficients=None,
                       **kw) -> dict:
        return {"radius": float(radius), "conic": float(conic),
                "coefficients": _coefficients(coefficients, self.num_terms)}

    def sag(self, p, x, y):
        r = torch.sqrt(x**2 + y**2)
        z = _conic_sag(p["radius"], p["conic"], x, y)
        c = p["coefficients"]
        term = r
        for i in range(self.num_terms):
            z = z + c[i] * term
            term = term * r
        return z

    def sag_grad(self, p, x, y):
        r2 = x**2 + y**2
        r = torch.sqrt(torch.clamp(r2, min=1e-30))
        dfdx, dfdy = _conic_sag_grad(p["radius"], p["conic"], x, y)
        c = p["coefficients"]
        # d(r^i)/dx = i r^(i-2) x
        term = safe_div(torch.ones_like(r), r)
        for i in range(self.num_terms):
            k = float(i + 1)
            dfdx = dfdx + k * x * c[i] * term
            dfdy = dfdy + k * y * c[i] * term
            term = term * r
        return dfdx, dfdy
