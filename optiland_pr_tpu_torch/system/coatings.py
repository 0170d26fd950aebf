"""Surface coatings (port of ``optiland_pr_tpu/system/coatings.py``).

- ``SimpleCoating``: a scalar intensity factor, the transmittance on a
  refracting surface and the reflectance on a mirror.
- ``FresnelCoating``: the s/p Fresnel coefficients of the interface, applied
  as a per-ray Jones matrix to the polarization chain of a polarized trace
  (``Optic.set_polarization``); without a polarized launch it leaves the
  rays as they are, as in the JAX package.

A coating is a static node; its numbers live in the surface's parameters.
"""
from __future__ import annotations

from ..core.polarization import fresnel_jones

__all__ = ["CoatingDef", "SimpleCoating", "FresnelCoating"]


class CoatingDef:
    kind = "base"
    polarization_dependent = False

    def default_params(self, **kw) -> dict:
        return {}


class SimpleCoating(CoatingDef):
    """Scalar reflectance/transmittance coating."""

    kind = "simple"

    def __init__(self, transmittance: float = 1.0, reflectance: float = 0.0):
        self._t = transmittance
        self._r = reflectance

    def default_params(self, **kw) -> dict:
        return {"transmittance": float(self._t),
                "reflectance": float(self._r)}

    def intensity_factor(self, p, reflect: bool):
        return p["reflectance"] if reflect else p["transmittance"]


class FresnelCoating(CoatingDef):
    """Uncoated-interface Fresnel interaction (polarization-dependent): the
    per-ray Jones matrix of the s/p amplitude coefficients of the interface
    between the surface's pre- and post-material."""

    kind = "fresnel"
    polarization_dependent = True

    def jones(self, n1, n2, aoi, reflect: bool):
        return fresnel_jones(n1, n2, aoi, reflect)
