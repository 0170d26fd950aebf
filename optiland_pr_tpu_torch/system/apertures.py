"""Physical (per-surface) apertures (port of the radial part of
``optiland_pr_tpu/system/apertures.py``).

An aperture is a static node; its extents live in the parameter tree.
``contains`` returns a boolean mask over ray coordinates in the surface's
local frame, and blocked rays get their intensity zeroed. Offset-radial,
elliptical, rectangular, polygon, file and boolean-composed apertures come later.
The system aperture (EPD, imageFNO, objectNA, float_by_stop_size) is set on
the ``Optic`` builder and read by ``trace/paraxial.py``.
"""
from __future__ import annotations

import math

__all__ = ["ApertureDef", "RadialAperture", "configure_aperture"]


class ApertureDef:
    kind = "base"

    def default_params(self, **kw) -> dict:
        raise NotImplementedError

    def contains(self, p, x, y):
        raise NotImplementedError


class RadialAperture(ApertureDef):
    """r_min <= r <= r_max annulus."""

    kind = "radial"

    def default_params(self, r_max=math.inf, r_min=0.0, **kw) -> dict:
        return {"r_max": float(r_max), "r_min": float(r_min)}

    def contains(self, p, x, y):
        r2 = x**2 + y**2
        return (r2 <= p["r_max"] ** 2) & (r2 >= p["r_min"] ** 2)


def configure_aperture(spec):
    """Resolve an ``add_surface(aperture=...)`` spec to (ApertureDef, params).
    A bare number is a lens diameter."""
    if spec is None:
        return None, None
    if isinstance(spec, (int, float)):
        ap = RadialAperture()
        return ap, ap.default_params(r_max=float(spec) / 2.0)
    if isinstance(spec, tuple) and len(spec) == 2 and isinstance(spec[0], ApertureDef):
        return spec
    if isinstance(spec, ApertureDef):
        return spec, spec.default_params()
    raise ValueError(f"Cannot resolve aperture spec: {spec!r}")
