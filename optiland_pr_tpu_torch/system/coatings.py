"""Surface coatings (port of ``optiland_pr_tpu/system/coatings.py``).

- ``SimpleCoating``: a scalar intensity factor, the transmittance on a
  refracting surface and the reflectance on a mirror.
- ``FresnelCoating``: the s/p Fresnel coefficients of the interface, applied
  to the polarization chain. The port has no polarization chain yet, so it is
  registered for the builder and refused by the kernel's ``supports_model``;
  the eager trace, like the JAX package's without a polarized launch, leaves
  the intensity as it is.

A coating is a static node; its numbers live in the surface's parameters.
"""
from __future__ import annotations

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
    """Uncoated-interface Fresnel interaction (polarization-dependent)."""

    kind = "fresnel"
    polarization_dependent = True
