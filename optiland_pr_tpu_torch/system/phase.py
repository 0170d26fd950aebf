"""Phase profiles of diffractive and metasurface interactions (port of
``optiland_pr_tpu/system/phase.py``).

A phase surface adds the surface-projected gradient of its profile to the
tangential wavevector, rebuilds the normal component from |k_out| = n2 k0,
shifts the OPD by -phase / k0 and scales the intensity by the profile's
diffraction efficiency (``trace/real.py``). The constant, radial and
linear-grating profiles run in the kernels too; the grid profile needs a
cell lookup per ray and stays on the eager trace.

``default_params`` returns host numbers, which ``Optic.build`` turns into
tensors (the ``phase`` subtree of the surface); ``phase`` and ``gradient``
take that subtree of tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PhaseProfileDef", "ConstantPhaseProfile", "RadialPhaseProfile",
           "LinearGratingPhaseProfile", "GridPhaseProfile"]


class PhaseProfileDef:
    kind = "base"
    efficiency: float = 1.0

    def default_params(self, **kw) -> dict:
        return {}

    def phase(self, p, x, y):
        raise NotImplementedError

    def gradient(self, p, x, y):
        """(dphi/dx, dphi/dy, dphi/dz)."""
        raise NotImplementedError

    def paraxial_gradient(self, p, y):
        _, gy, _ = self.gradient(p, torch.zeros_like(y), y)
        return gy


class ConstantPhaseProfile(PhaseProfileDef):
    kind = "constant"

    def __init__(self, efficiency: float = 1.0):
        self.efficiency = efficiency

    def default_params(self, phase=0.0, **kw):
        return {"phase": float(phase)}

    def phase(self, p, x, y):
        return p["phase"] * torch.ones_like(x)

    def gradient(self, p, x, y):
        z = torch.zeros_like(x)
        return z, z, z


class RadialPhaseProfile(PhaseProfileDef):
    """phi(r) = sum_i c_i r^(2(i+1))."""

    kind = "radial"

    def __init__(self, num_terms: int, efficiency: float = 1.0):
        self.num_terms = int(num_terms)
        self.efficiency = efficiency

    def default_params(self, coefficients=None, **kw):
        c = np.zeros(self.num_terms, np.float64)
        if coefficients is not None and len(coefficients):
            c[:len(coefficients)] = np.asarray(coefficients, np.float64)
        return {"coefficients": c}

    def phase(self, p, x, y):
        r2 = x**2 + y**2
        phase = torch.zeros_like(x)
        term = r2
        for i in range(self.num_terms):
            phase = phase + p["coefficients"][i] * term
            term = term * r2
        return phase

    def gradient(self, p, x, y):
        r2 = x**2 + y**2
        r = torch.sqrt(r2)
        d_dr = torch.zeros_like(r)
        for i in range(self.num_terms):
            power = i + 1
            d_dr = d_dr + p["coefficients"][i] * 2 * power \
                * r ** (2 * power - 1)
        safe_r = torch.where(r == 0, 1.0, r)
        return (d_dr / safe_r) * x, (d_dr / safe_r) * y, torch.zeros_like(x)


class LinearGratingPhaseProfile(PhaseProfileDef):
    """phi = Kx x + Ky y with |K| = 2 pi order / period."""

    kind = "linear_grating"

    def __init__(self, efficiency: float = 1.0):
        self.efficiency = efficiency

    def default_params(self, period=1.0, angle=0.0, order=1, **kw):
        return {"period": float(period), "angle": float(angle),
                "order": float(order)}

    def _K(self, p):
        mag = 2 * math.pi * p["order"] / p["period"]
        return mag * torch.cos(p["angle"]), mag * torch.sin(p["angle"])

    def phase(self, p, x, y):
        Kx, Ky = self._K(p)
        return Kx * x + Ky * y

    def gradient(self, p, x, y):
        Kx, Ky = self._K(p)
        one = torch.ones_like(x)
        return Kx * one, Ky * one, torch.zeros_like(x)


class GridPhaseProfile(PhaseProfileDef):
    """A tabulated phase grid, bilinear in each cell (no kernel takes it:
    the cell lookup stays on the eager trace)."""

    kind = "grid"

    def __init__(self, nx: int, ny: int, efficiency: float = 1.0):
        self.nx = int(nx)
        self.ny = int(ny)
        self.efficiency = efficiency

    def default_params(self, x_coords=None, y_coords=None, phase_grid=None,
                       **kw):
        if x_coords is None:
            x_coords = np.linspace(-1.0, 1.0, self.nx)
        if y_coords is None:
            y_coords = np.linspace(-1.0, 1.0, self.ny)
        if phase_grid is None:
            phase_grid = np.zeros((self.ny, self.nx))
        return {"x_coords": np.asarray(x_coords, np.float64),
                "y_coords": np.asarray(y_coords, np.float64),
                "phase_grid": np.asarray(phase_grid, np.float64)}

    def _cell(self, p, x, y):
        xc, yc = p["x_coords"], p["y_coords"]
        ix = torch.clamp(torch.searchsorted(xc, x.contiguous()) - 1, 0,
                         self.nx - 2)
        iy = torch.clamp(torch.searchsorted(yc, y.contiguous()) - 1, 0,
                         self.ny - 2)
        x0, x1 = xc[ix], xc[ix + 1]
        y0, y1 = yc[iy], yc[iy + 1]
        tx = (x - x0) / (x1 - x0)
        ty = (y - y0) / (y1 - y0)
        g = p["phase_grid"]
        return (x1 - x0, y1 - y0, tx, ty, g[iy, ix], g[iy, ix + 1],
                g[iy + 1, ix], g[iy + 1, ix + 1])

    def phase(self, p, x, y):
        dx, dy, tx, ty, z00, z01, z10, z11 = self._cell(p, x, y)
        return ((1 - ty) * ((1 - tx) * z00 + tx * z01)
                + ty * ((1 - tx) * z10 + tx * z11))

    def gradient(self, p, x, y):
        dx, dy, tx, ty, z00, z01, z10, z11 = self._cell(p, x, y)
        gx = ((1 - ty) * (z01 - z00) + ty * (z11 - z10)) / dx
        gy = ((1 - tx) * (z10 - z00) + tx * (z11 - z01)) / dy
        return gx, gy, torch.zeros_like(x)
