"""Sample systems beyond the all-conic objectives (port of the matching part
of ``optiland_pr_tpu/samples/catalog.py``, with the same public
prescriptions: the Hubble telescope, the aspheric singlet and the 25-surface
objective of U.S. Patent 8,879,901 and the telecentric DUV projection lens
of U.S. Patent 5,831,776), and the single-lens test systems of the
JAX package's kernel suite (``tests/test_pallas_widened.py``): a tilted and
decentered singlet, a coated singlet and an odd-asphere singlet."""
from __future__ import annotations

import math

from ..materials import IdealMaterial
from ..system.apertures import RadialAperture
from ..system.coatings import SimpleCoating
from ..system.optic import Optic

__all__ = ["HubbleTelescope", "AsphericSinglet", "ObjectiveUS008879901",
           "UVProjectionLens", "TiltedSinglet", "CoatedSinglet",
           "OddAsphereSinglet"]

inf = math.inf
# the Fraunhofer F, d and C lines, d primary
_FRAUNHOFER = [(0.48613270, False), (0.58756180, True), (0.65627250, False)]


def HubbleTelescope() -> Optic:
    """Hubble: a two-mirror Ritchey-Chretien with a central obscuration."""
    lens = Optic(name="Hubble Space Telescope")
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, thickness=4910.01016)
    obscuration = (RadialAperture(),
                   RadialAperture().default_params(r_max=inf,
                                                   r_min=177.80035))
    lens.add_surface(index=2, radius=-11040.02286, thickness=-4910.01016,
                     material="mirror", is_stop=True, conic=-1.001152,
                     aperture=obscuration)
    lens.add_surface(index=3, radius=-1349.31166, thickness=6365.20955,
                     material="mirror", conic=-1.483014)
    lens.add_surface(index=4, radius=-635.38227)
    lens.set_aperture(aperture_type="EPD", value=2400)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0)
    lens.add_field(y=0.15)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens


def AsphericSinglet() -> Optic:
    """N-SF11 singlet with an even-aspheric front surface."""
    lens = Optic(name="Aspheric Singlet")
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, thickness=7, radius=20.0, is_stop=True,
                     material="N-SF11", surface_type="even_asphere",
                     conic=0.0,
                     coefficients=[-2.248851e-4, -4.690412e-6, -6.404376e-8])
    lens.add_surface(index=2, thickness=21.56201105)
    lens.add_surface(index=3)
    lens.set_aperture(aperture_type="EPD", value=20.0)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0)
    lens.add_wavelength(value=0.587, is_primary=True)
    return lens


def ObjectiveUS008879901() -> Optic:
    """25-surface camera objective, U.S. Patent 8,879,901: catalog glasses,
    a plane stop and a plane-parallel plate, f/2 in image space."""
    lens = Optic(name="Objective US 8,879,901")
    lens.add_surface(index=0, radius=inf, thickness=inf)
    rows = [  # (radius, thickness, material), surfaces 1-24
        (47.07125235, 5.29811826, "N-LAF32"), (184.28171667, 0.6, None),
        (29.92177645, 7.13654863, "H-ZLAF52A"), (50.4992638, 2.0, None),
        (60.5004845, 0.99941671, "E-SF1"), (17.72638376, 9.9, None),
        (inf, 8.7, None),
        (-17.49862241, 1.29934579, ("SF4", "hikari")),
        (1000.00000019, 8.44325264, "M-TAF1"), (-28.00122422, 0.1, None),
        (-141.99976777, 6.79950254, "M-TAF1"), (-35.94103045, 0.516, None),
        (92.00034667, 3.29901361, "Q-LAFPH1S"),
        (-277.85210888, 2.13, None),
        (-157.24588662, 1.29980422, "S-FSL5"), (740.47397742, 0.25, None),
        (19.91929498, 5.59345688, "J-LASF015"), (36.48852623, 0.574, None),
        (45.97532235, 1.00045731, "E-SF1"), (16.39521847, 2.951, None),
        (33.86131631, 3.22444231, "H-LAK52"), (inf, 8.0, None),
        (inf, 4.0, "H-LAK52"), (inf, 3.15317838, None)]
    for k, (radius, thickness, material) in enumerate(rows, start=1):
        kw = {} if material is None else {"material": material}
        lens.add_surface(index=k, radius=radius, thickness=thickness,
                         is_stop=k == 7, **kw)
    lens.add_surface(index=25)
    lens.set_aperture(aperture_type="imageFNO", value=2.0)
    lens.set_field_type(field_type="angle")
    for y in (0.0, 7.574, 10.82):
        lens.add_field(y=y)
    for wl, primary in _FRAUNHOFER:
        lens.add_wavelength(value=wl, is_primary=primary)
    return lens


def UVProjectionLens() -> Optic:
    """The 42-surface object-space telecentric DUV lithography lens of U.S.
    Patent 5,831,776 (``optiland_pr_tpu/samples/catalog.py:175-210``):
    fused silica as an ideal index at 0.248 um, object NA 0.133, object
    heights 0, 32 and 48 mm, the image plane placed by ``image_solve``."""
    sio2 = IdealMaterial(n=1.5084, k=0)
    rows = [
        (-737.7847, 27.484, 1), (-235.2891, 0.916, 0), (211.1786, 36.646, 1),
        (-461.3986, 0.916, 0), (412.6778, 21.071, 1), (160.5391, 16.197, 0),
        (-604.1283, 7.215, 1), (218.1877, 23.941, 0), (-3586.063, 11.978, 1),
        (251.8168, 47.506, 0), (-85.2817, 11.961, 1), (584.8597, 9.968, 0),
        (4074.801, 35.291, 1), (-162.0185, 0.923, 0), (629.544, 41.227, 1),
        (-226.7397, 0.916, 0), (522.2739, 27.842, 1), (-582.424, 0.916, 0),
        (423.729, 22.904, 1), (-1385.36, 0.916, 0), (212.039, 33.646, 1),
        (802.3695, 55.304, 0), (-776.5697, 8.703, 1), (106.1728, 24.09, 0),
        (-200.683, 11.452, 1), (311.8264, 59.54, 0), (-77.2276, 11.772, 1),
        (2317.8032, 11.862, 0), (-290.8859, 22.904, 1), (-148.3577, 1.373, 0),
        (-5658.5043, 41.227, 1), (-151.9858, 0.916, 0), (678.1005, 32.981, 1),
        (-358.554, 0.916, 0), (264.2734, 32.814, 1), (2309.6884, 0.916, 0),
        (171.2681, 29.015, 1), (364.7765, 0.918, 0), (113.37, 76.259, 1),
        (78.6982, 54.304, 0), (49.5443, 18.65, 1), (109.8136, 13.07647896, 0),
    ]
    lens = Optic(name="UV Projection Lens")
    lens.add_surface(index=0, radius=inf, thickness=110.85883544)
    for i, (radius, thickness, is_glass) in enumerate(rows, start=1):
        lens.add_surface(index=i, radius=radius, thickness=thickness,
                         material=sio2 if is_glass else None,
                         is_stop=(i == 20))
    lens.add_surface(index=43, radius=inf)
    lens.set_aperture(aperture_type="objectNA", value=0.133)
    lens.set_field_type(field_type="object_height")
    lens.add_field(y=0)
    lens.add_field(y=32)
    lens.add_field(y=48)
    lens.add_wavelength(value=0.248, is_primary=True)
    lens.obj_space_telecentric = True
    lens.image_solve()
    return lens


def TiltedSinglet() -> Optic:
    """N-BK7 singlet whose front surface is tilted 2 degrees about x and
    decentered 0.5 mm, and whose back surface is tilted -1 degree about y."""
    lens = Optic(name="tilted singlet")
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, radius=60.0, thickness=8.0, material="N-BK7",
                     is_stop=True, dx=0.5, rx=math.radians(2.0))
    lens.add_surface(index=2, radius=-400.0, thickness=95.0,
                     ry=math.radians(-1.0))
    lens.add_surface(index=3)
    lens.set_aperture(aperture_type="EPD", value=20.0)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0)
    lens.add_field(y=2)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens


def CoatedSinglet() -> Optic:
    """Singlet of an ideal, non-absorbing index whose two surfaces transmit
    96% and 98%, so the coatings are its only intensity change."""
    lens = Optic(name="coated singlet")
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, radius=60.0, thickness=8.0, material=1.5168,
                     is_stop=True, coating=SimpleCoating(transmittance=0.96))
    lens.add_surface(index=2, radius=-400.0, thickness=95.0,
                     coating=SimpleCoating(transmittance=0.98))
    lens.add_surface(index=3)
    lens.set_aperture(aperture_type="EPD", value=20.0)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens


def OddAsphereSinglet() -> Optic:
    """Singlet with an odd-aspheric front surface (powers of r)."""
    lens = Optic(name="odd-asphere singlet")
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, radius=55.0, conic=-0.4, thickness=7.0,
                     material=1.5168, is_stop=True,
                     surface_type="odd_asphere",
                     coefficients=[1e-5, -2e-6, 4e-8])
    lens.add_surface(index=2, radius=-300.0, thickness=90.0)
    lens.add_surface(index=3)
    lens.set_aperture(aperture_type="EPD", value=18.0)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0)
    lens.add_field(y=2)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens
