"""Plane and sphere/conic geometries with closed-form intersection
(port of ``optiland_pr_tpu/geometry/standard.py``)."""
from __future__ import annotations

import math

import torch

from ..core.safe_math import safe_div
from .base import Geometry, conic_distance

__all__ = ["Plane", "StandardGeometry"]


def _conic_sag(radius, conic, x, y):
    """z = r^2 / (R (1 + sqrt(1 - (1+k) r^2 / R^2))), guarded for R = inf."""
    is_plane = torch.isinf(radius)
    R = torch.where(is_plane, 1.0, radius)
    r2 = x**2 + y**2
    arg = 1.0 - (1.0 + conic) * r2 / R**2
    ok = arg >= 0
    # out-of-domain points get the rim-clamped value, not NaN: validity is
    # tracked by the intersection mask and NaN is set once, at the end
    root = torch.sqrt(torch.where(ok, arg, 0.0) + torch.where(ok, 0.0, 1e-12))
    z = r2 / (R * (1.0 + root))
    return torch.where(is_plane, torch.zeros_like(z), z)


def _conic_sag_grad(radius, conic, x, y):
    """(dz/dx, dz/dy) = (x, y) / (R sqrt(1 - (1+k) r^2/R^2)), guarded."""
    is_plane = torch.isinf(radius)
    R = torch.where(is_plane, 1.0, radius)
    r2 = x**2 + y**2
    arg = 1.0 - (1.0 + conic) * r2 / R**2
    ok = arg >= 0
    root = torch.sqrt(torch.where(ok, arg, 1.0))
    denom = R * root
    dfdx = safe_div(x, denom)
    dfdy = safe_div(y, denom)
    zero = torch.zeros_like(dfdx)
    return torch.where(is_plane, zero, dfdx), torch.where(is_plane, zero, dfdy)


class Plane(Geometry):
    """Infinite plane at z = 0."""

    kind = "plane"

    def default_params(self, **kw) -> dict:
        # radius/conic kept for a uniform paraxial interface (power 0)
        return {"radius": math.inf, "conic": 0.0}

    def sag(self, p, x, y):
        return torch.zeros_like(x + y)

    def sag_grad(self, p, x, y):
        zero = torch.zeros_like(x + y)
        return zero, zero

    def normal(self, p, x, y):
        # +z, as the reference Plane, unlike the conic df/dz = -1 convention;
        # interactions align the normal against the ray anyway
        zero = torch.zeros_like(x + y)
        return zero, zero, torch.ones_like(zero)

    def distance(self, p, x, y, z, L, M, N):
        return safe_div(-z, N)


class StandardGeometry(Geometry):
    """Sphere/conic z = r^2/(R(1+sqrt(1-(1+k)r^2/R^2))), closed-form
    intersection."""

    kind = "standard"

    def default_params(self, radius=math.inf, conic=0.0, **kw) -> dict:
        return {"radius": float(radius), "conic": float(conic)}

    def sag(self, p, x, y):
        return _conic_sag(p["radius"], p["conic"], x, y)

    def sag_grad(self, p, x, y):
        return _conic_sag_grad(p["radius"], p["conic"], x, y)

    def distance(self, p, x, y, z, L, M, N):
        return conic_distance(p["radius"], p["conic"], x, y, z, L, M, N)
