"""Asphere and freeform sags (port of ``optiland_pr_tpu/geometry/
aspheres.py``): even and odd aspheres (a conic base plus a polynomial in r^2
or r), the XY polynomial and Chebyshev freeforms (a conic base plus a grid
of x^i y^j or T_i(x/nx) T_j(y/ny) terms), the biconic and the toroid, all
intersected by ``newton_distance``.

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

__all__ = ["EvenAsphere", "OddAsphere", "PolynomialXY", "ChebyshevSag",
           "Biconic", "Toroidal"]


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


def _grid(values, num_x: int, num_y: int) -> np.ndarray:
    """``values`` as a float64 [num_x, num_y] grid, zero-padded."""
    out = np.zeros((num_x, num_y), np.float64)
    if values is not None:
        v = np.atleast_2d(np.asarray(values, np.float64))[:num_x, :num_y]
        out[:v.shape[0], :v.shape[1]] = v
    return out


class PolynomialXY(Geometry):
    """z = conic + sum_ij C[i, j] x^i y^j (the XY freeform)."""

    kind = "polynomial_xy"

    def __init__(self, num_x: int, num_y: int):
        self.num_x = int(num_x)
        self.num_y = int(num_y)

    def default_params(self, radius=math.inf, conic=0.0, coefficients=None,
                       **kw) -> dict:
        return {"radius": float(radius), "conic": float(conic),
                "coefficients": _grid(coefficients, self.num_x, self.num_y)}

    @staticmethod
    def _powers(v, n):
        out = [torch.ones_like(v)]
        for _ in range(n - 1):
            out.append(out[-1] * v)
        return out                          # [v^0 .. v^(n-1)]

    def sag(self, p, x, y):
        z = _conic_sag(p["radius"], p["conic"], x, y)
        c = p["coefficients"]
        xp = self._powers(x, self.num_x)
        yp = self._powers(y, self.num_y)
        for i in range(self.num_x):
            for j in range(self.num_y):
                z = z + c[i, j] * xp[i] * yp[j]
        return z

    def sag_grad(self, p, x, y):
        dfdx, dfdy = _conic_sag_grad(p["radius"], p["conic"], x, y)
        c = p["coefficients"]
        xp = self._powers(x, self.num_x)
        yp = self._powers(y, self.num_y)
        for i in range(1, self.num_x):
            for j in range(self.num_y):
                dfdx = dfdx + i * c[i, j] * xp[i - 1] * yp[j]
        for i in range(self.num_x):
            for j in range(1, self.num_y):
                dfdy = dfdy + j * c[i, j] * xp[i] * yp[j - 1]
        return dfdx, dfdy


def _chebyshev_t(n, u):
    """T_0..T_{n-1}(u) by the recurrence."""
    ts = [torch.ones_like(u)]
    if n > 1:
        ts.append(u)
    for _ in range(2, n):
        ts.append(2 * u * ts[-1] - ts[-2])
    return ts


def _chebyshev_dt(n, u):
    """T'_0..T'_{n-1}(u) as T'_k = k U_{k-1}, U by its recurrence."""
    us = [torch.ones_like(u)]
    if n > 2:
        us.append(2 * u)
    for _ in range(3, n):
        us.append(2 * u * us[-1] - us[-2])
    dts = [torch.zeros_like(u)]
    for k in range(1, n):
        dts.append(k * us[k - 1])
    return dts


class ChebyshevSag(Geometry):
    """z = conic + sum_ij C[i, j] T_i(x / norm_x) T_j(y / norm_y)."""

    kind = "chebyshev"

    def __init__(self, num_x: int, num_y: int):
        self.num_x = int(num_x)
        self.num_y = int(num_y)

    def default_params(self, radius=math.inf, conic=0.0, coefficients=None,
                       norm_x=1.0, norm_y=1.0, **kw) -> dict:
        return {"radius": float(radius), "conic": float(conic),
                "coefficients": _grid(coefficients, self.num_x, self.num_y),
                "norm_x": float(norm_x), "norm_y": float(norm_y)}

    def sag(self, p, x, y):
        u = x / p["norm_x"]
        v = y / p["norm_y"]
        z = _conic_sag(p["radius"], p["conic"], x, y)
        c = p["coefficients"]
        tx = _chebyshev_t(self.num_x, u)
        ty = _chebyshev_t(self.num_y, v)
        for i in range(self.num_x):
            for j in range(self.num_y):
                z = z + c[i, j] * tx[i] * ty[j]
        return z

    def sag_grad(self, p, x, y):
        u = x / p["norm_x"]
        v = y / p["norm_y"]
        dfdx, dfdy = _conic_sag_grad(p["radius"], p["conic"], x, y)
        c = p["coefficients"]
        tx = _chebyshev_t(self.num_x, u)
        ty = _chebyshev_t(self.num_y, v)
        dtx = _chebyshev_dt(self.num_x, u)
        dty = _chebyshev_dt(self.num_y, v)
        # T' at the normalized coordinate without the 1/norm factor of the
        # chain rule: the reference's quirk, which the JAX package keeps too
        for i in range(self.num_x):
            for j in range(self.num_y):
                if i > 0:
                    dfdx = dfdx + c[i, j] * dtx[i] * ty[j]
                if j > 0:
                    dfdy = dfdy + c[i, j] * tx[i] * dty[j]
        return dfdx, dfdy


class Biconic(Geometry):
    """z = cx x^2 / (1 + sqrt(1 - (1+kx) cx^2 x^2))
         + cy y^2 / (1 + sqrt(1 - (1+ky) cy^2 y^2)).

    ``radius``/``conic`` are (Ry, ky), the Newton warm start's conic and the
    paraxial y-power, as the reference takes Ry for the base radius."""

    kind = "biconic"

    def default_params(self, radius=math.inf, conic=0.0, radius_x=math.inf,
                       conic_x=0.0, **kw) -> dict:
        return {"radius": float(radius), "conic": float(conic),
                "radius_x": float(radius_x), "conic_x": float(conic_x)}

    @staticmethod
    def _curvature(R):
        return torch.where(torch.isinf(R), 0.0,
                           safe_div(torch.ones_like(R), R))

    @staticmethod
    def _axis_sag(R, k, v):
        c = Biconic._curvature(R)
        arg = 1.0 - (1.0 + k) * c**2 * v**2
        arg = torch.where(arg < 1e-14, 0.0, arg)
        denom = 1.0 + torch.sqrt(arg)
        return (c * v**2) / torch.where(torch.abs(denom) < 1e-14, 1e-14,
                                        denom)

    @staticmethod
    def _axis_grad(R, k, v):
        c = Biconic._curvature(R)
        arg = 1.0 - (1.0 + k) * c**2 * v**2
        arg = torch.where(arg < 1e-14, 1e-14, arg)
        return (c * v) / torch.sqrt(arg)

    def sag(self, p, x, y):
        return (self._axis_sag(p["radius_x"], p["conic_x"], x)
                + self._axis_sag(p["radius"], p["conic"], y))

    def sag_grad(self, p, x, y):
        return (self._axis_grad(p["radius_x"], p["conic_x"], x),
                self._axis_grad(p["radius"], p["conic"], y))


class Toroidal(Geometry):
    """A y-z curve (conic + even polynomial in y) swept about an axis
    parallel to y at the distance R_rot:
    z = z_y + (R - z_y) - sign(R - z_y) sqrt((R - z_y)^2 - x^2).

    ``radius``/``conic`` are the y-z curve's (and the warm start's);
    ``radius_rot`` the x-z rotation radius; ``coeffs_poly_y[i]`` the
    coefficient of y^(2(i+1))."""

    kind = "toroidal"
    radius_rot_is_inf: bool | None = None

    def __init__(self, num_terms: int = 0):
        self.num_terms = int(num_terms)

    def default_params(self, radius=math.inf, conic=0.0, radius_rot=math.inf,
                       coeffs_poly_y=None, **kw) -> dict:
        return {"radius": float(radius), "conic": float(conic),
                "radius_rot": float(radius_rot),
                "coeffs_poly_y": _coefficients(coeffs_poly_y,
                                               self.num_terms)}

    def _zy(self, p, y):
        z = Biconic._axis_sag(p["radius"], p["conic"], y)
        y2 = y**2
        term = y2
        for i in range(self.num_terms):
            z = z + p["coeffs_poly_y"][i] * term
            term = term * y2
        return z

    def _dzy(self, p, y):
        dz = Biconic._axis_grad(p["radius"], p["conic"], y)
        y2 = y**2
        term = y
        for i in range(self.num_terms):
            dz = dz + 2.0 * (i + 1) * p["coeffs_poly_y"][i] * term
            term = term * y2
        return dz

    def sag(self, p, x, y):
        z_y = self._zy(p, y)
        R = p["radius_rot"]
        is_inf = torch.isinf(R)
        Rs = torch.where(is_inf, 1.0, R)
        inside = (Rs - z_y) ** 2 - x**2
        ok = inside >= 0
        root = torch.sqrt(torch.where(ok, inside, 0.0)
                          + torch.where(ok, 0.0, 1e-12))
        z_tor = z_y + (Rs - z_y) - torch.sign(Rs - z_y) * root
        return torch.where(is_inf, z_y, z_tor)

    def sag_grad(self, p, x, y):
        z_y = self._zy(p, y)
        dz_dy = self._dzy(p, y)
        R = p["radius_rot"]
        is_inf = torch.isinf(R)
        Rs = torch.where(is_inf, 1.0, R)
        inside = (Rs - z_y) ** 2 - x**2
        ok = inside >= 0
        root = torch.sqrt(torch.where(ok, torch.clamp(inside, min=1e-14),
                                      1e-14))
        fx = torch.where(ok, torch.sign(Rs) * x / root, 0.0)
        fy = torch.where(ok, torch.sign(Rs) * (Rs - z_y) * dz_dy / root, 0.0)
        dfdx = torch.where(is_inf, torch.zeros_like(fx), fx)
        dfdy = torch.where(is_inf, dz_dy, fy)
        return dfdx, dfdy
