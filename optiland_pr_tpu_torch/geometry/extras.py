"""The Zernike sag and the two thin Fresnel surfaces (port of the matching
part of ``optiland_pr_tpu/geometry/extras.py``).

- ``ZernikeSag``: a conic base plus sum_j c_j Z_j(rho / norm_radius, phi) in
  the standard (ANSI), fringe or Noll basis, intersected by
  ``newton_distance``;
- ``FresnelZoneSag``: the parent conic collapsed into zones of a fixed depth;
  a ray meets it at its base plane and refracts with the parent's slope;
- ``FresnelDesignedSag``: a flat Fresnel lens whose facet slopes are
  designed for the flat geometry, m = -sin t / (n_design - cos t) with
  tan t = r / f; a ray meets it at its base plane.

The grid sag and the gratings come with later slices.
"""
from __future__ import annotations

import math

import torch

from ..core.safe_math import safe_div
from ..core.zernike import _norm_factor, _radial_coeffs, zernike_eval, \
    zernike_terms
from .aspheres import _coefficients
from .base import Geometry
from .standard import _conic_sag, _conic_sag_grad

__all__ = ["ZernikeSag", "FresnelZoneSag", "FresnelDesignedSag"]


def _zernike_slopes(zernike_type: str, coeffs, rho, phi):
    """(dz/drho, dz/dphi) of sum_j coeffs[j] Z_j(rho, phi), in closed
    form."""
    d_rho = torch.zeros_like(rho)
    d_phi = torch.zeros_like(rho)
    for j, (n, m) in enumerate(zernike_terms(zernike_type, len(coeffs))):
        R = torch.zeros_like(rho)
        dR = torch.zeros_like(rho)
        for p, c in _radial_coeffs(n, m):
            R = R + c * rho**p
            if p > 0:
                dR = dR + p * c * rho**(p - 1)
        cj = coeffs[j] * _norm_factor(zernike_type, n, m)
        if m > 0:
            ang, dang = torch.cos(m * phi), -m * torch.sin(m * phi)
        elif m < 0:
            ang, dang = torch.sin(-m * phi), -m * torch.cos(-m * phi)
        else:
            d_rho = d_rho + cj * dR
            continue
        d_rho = d_rho + cj * dR * ang
        d_phi = d_phi + cj * R * dang
    return d_rho, d_phi


class ZernikeSag(Geometry):
    """conic + sum_j c_j Z_j(rho / norm_radius, phi)."""

    kind = "zernike"

    def __init__(self, num_terms: int, zernike_type: str = "standard"):
        self.num_terms = int(num_terms)
        self.zernike_type = zernike_type

    def default_params(self, radius=math.inf, conic=0.0, coefficients=None,
                       norm_radius=1.0, **kw) -> dict:
        return {"radius": float(radius), "conic": float(conic),
                "coefficients": _coefficients(coefficients, self.num_terms),
                "norm_radius": float(norm_radius)}

    def sag(self, p, x, y):
        z = _conic_sag(p["radius"], p["conic"], x, y)
        rho = torch.sqrt(x**2 + y**2) / p["norm_radius"]
        phi = torch.atan2(y, x)
        return z + zernike_eval(self.zernike_type, p["coefficients"], rho,
                                phi)

    def sag_grad(self, p, x, y):
        dfdx, dfdy = _conic_sag_grad(p["radius"], p["conic"], x, y)
        nr = p["norm_radius"]
        r = torch.sqrt(x**2 + y**2)
        r_safe = torch.clamp(r, min=1e-12)
        d_rho, d_phi = _zernike_slopes(self.zernike_type, p["coefficients"],
                                       r / nr, torch.atan2(y, x))
        dfdx = dfdx + d_rho * x / (r_safe * nr) - d_phi * y / r_safe**2
        dfdy = dfdy + d_rho * y / (r_safe * nr) + d_phi * x / r_safe**2
        return dfdx, dfdy


class FresnelZoneSag(Geometry):
    """The parent conic collapsed into annular zones of depth
    ``zone_depth``: z(r) = conic_sag(r) mod zone_depth. A ray meets the
    surface at its base plane z = 0 (the zones are optically thin) and
    refracts with the parent profile's slope, which the molded facets
    realize; facet-height parallax and draft shadowing are neglected."""

    kind = "fresnel_zone"

    def default_params(self, radius=math.inf, conic=0.0, zone_depth=1.0,
                       **kw) -> dict:
        return {"radius": float(radius), "conic": float(conic),
                "zone_depth": float(zone_depth)}

    def sag(self, p, x, y):
        z_parent = _conic_sag(p["radius"], p["conic"], x, y)
        d = p["zone_depth"]
        return z_parent - d * torch.floor(z_parent / d)

    def sag_grad(self, p, x, y):
        return _conic_sag_grad(p["radius"], p["conic"], x, y)

    def distance(self, p, x, y, z, L, M, N):
        return safe_div(-z, N)


class FresnelDesignedSag(Geometry):
    """A flat Fresnel lens with facet angles designed for the flat
    geometry: for a glass (n_design) to air exit facet and collimated
    input, the facet slope is dz/dr = -sin t / (n_design - cos t) with
    tan t = r / f. ``radius`` defaults to the paraxial-equivalent radius
    -(n_design - 1) f, so first-order optics see the lens's power; a ray
    meets the surface at its base plane."""

    kind = "fresnel_designed"

    def default_params(self, radius=None, conic=0.0, focal_length=100.0,
                       n_design=1.5, zone_depth=1.0, **kw) -> dict:
        if radius is None or not math.isfinite(float(radius)):
            radius = -(n_design - 1.0) * focal_length
        return {"radius": float(radius), "conic": float(conic),
                "focal_length": float(focal_length),
                "n_design": float(n_design), "zone_depth": float(zone_depth)}

    @staticmethod
    def _slope(p, r):
        f = p["focal_length"]
        hyp = torch.sqrt(r**2 + f**2)
        return -(r / hyp) / (p["n_design"] - f / hyp)

    def sag(self, p, x, y):
        return torch.zeros_like(x + y)

    def sag_grad(self, p, x, y):
        r = torch.sqrt(x**2 + y**2)
        r_safe = torch.clamp(r, min=1e-12)
        m = self._slope(p, r)
        return m * x / r_safe, m * y / r_safe

    def distance(self, p, x, y, z, L, M, N):
        return safe_div(-z, N)
