"""Sample objective lenses whose surfaces are all conic or plane (port of
the matching part of ``optiland_pr_tpu/samples/objectives.py``; the
prescriptions are the same public designs), and a singlet that loses rays
to total internal reflection."""
from __future__ import annotations

import math

from ..system.optic import Optic

__all__ = ["CookeTriplet", "DoubleGauss", "TripletTelescopeObjective",
           "ReverseTelephoto", "TessarLens", "TIRSinglet"]

inf = math.inf


def CookeTriplet() -> Optic:
    """f/5 Cooke triplet."""
    lens = Optic(name="Cooke Triplet")
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, radius=22.01359, thickness=3.25896,
                     material="SK16")
    lens.add_surface(index=2, radius=-435.76044, thickness=6.00755)
    lens.add_surface(index=3, radius=-22.21328, thickness=0.99997,
                     material=("F2", "schott"))
    lens.add_surface(index=4, radius=20.29192, thickness=4.75041, is_stop=True)
    lens.add_surface(index=5, radius=79.68360, thickness=2.95208,
                     material="SK16")
    lens.add_surface(index=6, radius=-18.39533, thickness=42.20778)
    lens.add_surface(index=7)
    lens.set_aperture(aperture_type="EPD", value=10)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0)
    lens.add_field(y=14)
    lens.add_field(y=20)
    lens.add_wavelength(value=0.48)
    lens.add_wavelength(value=0.55, is_primary=True)
    lens.add_wavelength(value=0.65)
    return lens


def DoubleGauss() -> Optic:
    """f/5 double Gauss."""
    lens = Optic(name="Double Gauss")
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, radius=56.20238, thickness=8.75,
                     material="N-SSK2")
    lens.add_surface(index=2, radius=152.28580, thickness=0.5)
    lens.add_surface(index=3, radius=37.68262, thickness=12.5,
                     material="N-SK2")
    lens.add_surface(index=4, radius=inf, thickness=3.8,
                     material=("F5", "schott"))
    lens.add_surface(index=5, radius=24.23130, thickness=16.369445)
    lens.add_surface(index=6, radius=inf, thickness=13.747957, is_stop=True)
    lens.add_surface(index=7, radius=-28.37731, thickness=3.8,
                     material=("F5", "schott"))
    lens.add_surface(index=8, radius=inf, thickness=11, material="N-SK16")
    lens.add_surface(index=9, radius=-37.92546, thickness=0.5)
    lens.add_surface(index=10, radius=177.41176, thickness=7,
                     material="N-SK16")
    lens.add_surface(index=11, radius=-79.41143, thickness=61.487536)
    lens.add_surface(index=12)
    lens.set_aperture(aperture_type="imageFNO", value=5)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0)
    lens.add_field(y=10)
    lens.add_field(y=14)
    lens.add_wavelength(value=0.4861)
    lens.add_wavelength(value=0.5876, is_primary=True)
    lens.add_wavelength(value=0.6563)
    return lens


def TripletTelescopeObjective() -> Optic:
    """Triplet telescope objective."""
    lens = Optic(name="Triplet Telescope Objective")
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, radius=50.098, thickness=4.5, material="N-BK7",
                     is_stop=True)
    lens.add_surface(index=2, radius=-983.42, thickness=0.1)
    lens.add_surface(index=3, radius=56.671, thickness=4.5, material="N-BK7")
    lens.add_surface(index=4, radius=-171.15, thickness=5.571)
    lens.add_surface(index=5, radius=-97.339, thickness=3.5,
                     material=("SF1", "schott"))
    lens.add_surface(index=6, radius=81.454, thickness=75.132)
    lens.add_surface(index=7)
    lens.set_aperture(aperture_type="imageFNO", value=2.8)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0.0)
    lens.add_field(y=0.7)
    lens.add_field(y=1.0)
    lens.add_wavelength(value=0.4861)
    lens.add_wavelength(value=0.5876, is_primary=True)
    lens.add_wavelength(value=0.6563)
    return lens


def ReverseTelephoto() -> Optic:
    """Reverse telephoto (retrofocus)."""
    lens = Optic(name="Reverse Telephoto")
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, radius=1.69111096, thickness=0.08259680,
                     material="N-SK10")
    lens.add_surface(index=2, radius=0.94414496, thickness=0.8)
    lens.add_surface(index=3, radius=4.32100401, thickness=0.080256,
                     material="SK15")
    lens.add_surface(index=4, radius=1.78117621, thickness=0.5)
    lens.add_surface(index=5, radius=2.64050282, thickness=0.27638160,
                     material="BASF2")
    lens.add_surface(index=6, radius=-3.86177348, thickness=0.1)
    lens.add_surface(index=7, radius=1.05627661, thickness=0.2,
                     material="FK3")
    lens.add_surface(index=8, radius=-4.06933311, thickness=0.2001384)
    lens.add_surface(index=9, radius=inf, thickness=0.06688, is_stop=True)
    lens.add_surface(index=10, radius=-2.61246583, thickness=0.064372,
                     material=("SF15", "hikari"))
    lens.add_surface(index=11, radius=0.99117409, thickness=0.3)
    lens.add_surface(index=12, radius=9.03045960, thickness=0.18743120,
                     material="N-LAK12")
    lens.add_surface(index=13, radius=-1.35680743, thickness=2.35130547)
    lens.add_surface(index=14)
    lens.set_aperture(aperture_type="EPD", value=0.3)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0)
    lens.add_field(y=21)
    lens.add_field(y=30)
    lens.add_wavelength(value=0.4861)
    lens.add_wavelength(value=0.5876, is_primary=True)
    lens.add_wavelength(value=0.6563)
    return lens


def TessarLens() -> Optic:
    """Tessar objective."""
    lens = Optic(name="Tessar")
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, radius=1.3329, thickness=0.2791,
                     material="N-SK15")
    lens.add_surface(index=2, radius=-9.9754, thickness=0.2054)
    lens.add_surface(index=3, radius=-2.0917, thickness=0.09,
                     material=("F2", "schott"))
    lens.add_surface(index=4, radius=1.2123, thickness=0.0709)
    lens.add_surface(index=5, radius=inf, thickness=0.1534, is_stop=True)
    lens.add_surface(index=6, radius=-7.5205, thickness=0.09, material="K10")
    lens.add_surface(index=7, radius=1.3010, thickness=0.3389,
                     material="N-SK15")
    lens.add_surface(index=8, radius=-1.5218, thickness=3.4025)
    lens.add_surface(index=9)
    lens.set_aperture(aperture_type="imageFNO", value=4.5)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0)
    lens.add_field(y=10)
    lens.add_field(y=20.5)
    lens.add_wavelength(value=0.48613270)
    lens.add_wavelength(value=0.58756180, is_primary=True)
    lens.add_wavelength(value=0.65627250)
    return lens


def TIRSinglet() -> Optic:
    """Steep N-SF11 singlet (R = 6, EPD 11, 30 degree field): about a third
    of the full-field rays are lost to total internal reflection, so the
    lost-ray path does real work. It has no counterpart in the JAX package's
    samples."""
    lens = Optic(name="TIR singlet")
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, radius=6.0, thickness=5.0, material="N-SF11",
                     is_stop=True)
    lens.add_surface(index=2, radius=7.0, thickness=10.0)
    lens.add_surface(index=3)
    lens.set_aperture(aperture_type="EPD", value=11.0)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0.0)
    lens.add_field(y=30.0)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens
