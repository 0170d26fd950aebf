"""Builders of the same lens in the JAX package and in the port, and the
JAX kernel tables and flags in the port's terms, for the
``tests/test_torch_*.py`` comparisons."""
import math

import jax
import jax.numpy as jnp
import torch

import optiland_pr_tpu.kernels.pallas_trace as jpt
from chip_smoke import (FREEFORM_KW, bench_freeform, freeform_singlet,
                        mirror_relay, polarized_double_gauss,
                        polarized_doublet, zoned_concentrator)
import optiland_pr_tpu.samples as jsamples
import optiland_pr_tpu_torch.samples as tsamples
from optiland_pr_tpu.system import apertures as japertures
from optiland_pr_tpu.system import coatings as jcoatings
from optiland_pr_tpu.system.optic import Optic as JOptic
from optiland_pr_tpu_torch.kernels.gen_trace import SurfaceFlags, _q2d_count
from optiland_pr_tpu_torch.system import apertures as tapertures
from optiland_pr_tpu_torch.system import coatings as tcoatings
from optiland_pr_tpu_torch.system.optic import Optic as TOptic

# The test workers run beside each other, several to the machine's cores;
# the port's small CPU tensors gain nothing from 8 intra-op threads apiece.
torch.set_num_threads(2)


def jax_tir_singlet():
    """The JAX package's build of the port's ``TIRSinglet`` sample."""
    lens = JOptic(name="TIR singlet")
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
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


def _combined(optic, coatings, apertures):
    """Every feature of sub-slices (b) and (c)-even/odd in one singlet: a
    tilted, decentered, coated even asphere in an absorbing glass, then an
    odd asphere behind an offset annular aperture that blocks part of the
    beam."""
    lens = optic(name="combined widened singlet")
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=40.0, conic=-0.5, thickness=6.0,
                     material="N-BK7", is_stop=True,
                     surface_type="even_asphere",
                     coefficients=[2e-5, -1e-7], dx=0.3, dy=-0.2, rx=0.02,
                     ry=-0.01,
                     coating=coatings.SimpleCoating(transmittance=0.97))
    ap = apertures.OffsetRadialAperture()
    lens.add_surface(index=2, radius=-150.0, thickness=60.0,
                     surface_type="odd_asphere",
                     coefficients=[1e-4, -2e-6, 3e-8],
                     aperture=(ap, ap.default_params(r_max=7.0, r_min=0.8,
                                                     offset_x=0.4,
                                                     offset_y=-0.3)))
    lens.add_surface(index=3)
    lens.set_aperture(aperture_type="EPD", value=16.0)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0.0)
    lens.add_field(y=3.0)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens


def _singlet(optic):
    """A plain N-BK7 singlet whose every ray passes at both fields: the
    small system of the float64 wavefront references."""
    lens = optic(name="wavefront singlet")
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=50.0, thickness=6.0, material="N-BK7",
                     is_stop=True)
    lens.add_surface(index=2, radius=-300.0, thickness=85.0)
    lens.add_surface(index=3)
    lens.set_aperture(aperture_type="EPD", value=16.0)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0.0)
    lens.add_field(y=5.0)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens


def _tilted_image_singlet(optic):
    """The wavefront singlet with a curved image surface (R -200 mm), tilted
    by 0.02 rad about x and decentered by 0.05 mm in y: a Huygens image grid
    goes through the image surface's sag and pose."""
    lens = optic(name="tilted image singlet")
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=50.0, thickness=6.0, material="N-BK7",
                     is_stop=True)
    lens.add_surface(index=2, radius=-300.0, thickness=85.0)
    lens.add_surface(index=3, radius=-200.0, rx=0.02, dy=0.05)
    lens.set_aperture(aperture_type="EPD", value=16.0)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0.0)
    lens.add_field(y=5.0)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens


def _newton_stack(optic):
    """Three Newton sags in one stack, on the faces of two thin lenses: a
    3 x 3 Chebyshev grid, six standard Zernike terms and a toroid, then a
    conic, fields 0 and 2 degrees. The grid and the Zernike terms are cut
    from the suite's singlets, and the other Newton kinds left to the
    singlets, so that the JAX K2 of the stack takes seconds in the Pallas
    interpreter."""
    cheb = [[0.0, 1e-4, 0.0], [5e-5, 0.0, 1e-5], [0.0, 3e-5, 0.0]]
    faces = (
        ("chebyshev", 60.0, 6.0, 1.5168,
         dict(norm_x=10.0, norm_y=10.0, coefficients=cheb)),
        ("zernike", -320.0, 4.0, None,
         dict(zernike_type="standard", norm_radius=10.0,
              coefficients=[0.0, 2e-4, -1e-4, 5e-4, 3e-4, -2e-4])),
        ("toroidal", 80.0, 5.0, 1.5168,
         dict(radius_rot=150.0, coeffs_poly_y=[1e-5])),
        ("standard", -150.0, 60.0, None, {}))
    return _thin_lenses(optic, "freeform stack", faces)


def _leaves_stack(optic):
    """The Newton kinds and bases the Newton stack leaves out, on the faces
    of three thin lenses: a 3 x 3 XY polynomial, a biconic, a toroid at an
    infinite rotation radius, six fringe and six Noll Zernike terms, then a
    conic, fields 0 and 2 degrees."""
    poly = [[0.0, 0.0, 1e-5], [0.0, 2e-6, 0.0], [1e-5, 0.0, 0.0]]
    faces = (
        ("polynomial", 60.0, 6.0, 1.5168, dict(coefficients=poly)),
        ("biconic", -320.0, 3.0, None, dict(radius_x=-250.0, conic_x=-0.5)),
        ("toroidal", 80.0, 5.0, 1.5168, dict(coeffs_poly_y=[1e-5, -2e-7])),
        ("zernike", -150.0, 3.0, None,
         dict(zernike_type="fringe", norm_radius=10.0,
              coefficients=[0.0, 1e-4, -2e-4, 4e-4, 2e-4, 1e-4])),
        ("zernike", 120.0, 4.0, 1.5168,
         dict(zernike_type="noll", norm_radius=9.0,
              coefficients=[0.0, -1e-4, 2e-4, 3e-4, -2e-4, 1e-4])),
        ("standard", -200.0, 50.0, None, {}))
    return _thin_lenses(optic, "freeform leaves stack", faces)


def _thin_lenses(optic, name, faces):
    """Faces (surface type, radius, thickness, material, keywords) after
    the object, the first the stop, EPD 12, fields 0 and 2 degrees."""
    lens = optic(name=name)
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    for k, (surface_type, radius, thickness, material, kw) in enumerate(
            faces, start=1):
        lens.add_surface(index=k, radius=radius, thickness=thickness,
                         material=material, is_stop=k == 1,
                         surface_type=surface_type, **kw)
    lens.add_surface(index=len(faces) + 1)
    lens.set_aperture(aperture_type="EPD", value=12.0)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0)
    lens.add_field(y=2)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens


def _fresnel_stack(optic):
    """Both thin Fresnel kinds: a zoned lens on the front of an N-BK7 plate
    whose exit face is a designed Fresnel lens; then both Forbes kinds: a
    lens with a three-term Qbfs front and a Q2D back whose m = 1 cosine
    group has four terms (the readout's -2/5 al_3 term), fields 0 and 2
    degrees."""
    lens = optic(name="Fresnel stack")
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=200.0, conic=-0.5, thickness=5.0,
                     material="N-BK7", is_stop=True,
                     surface_type="fresnel_zone", zone_depth=0.5)
    lens.add_surface(index=2, surface_type="fresnel_designed",
                     focal_length=150.0, n_design=1.5168, zone_depth=0.5,
                     thickness=3.0)
    lens.add_surface(index=3, radius=90.0, conic=-0.3, thickness=5.0,
                     material="N-BK7", surface_type="forbes_qbfs",
                     norm_radius=12.0, coefficients=[8e-4, -4e-4, 1.5e-4])
    lens.add_surface(index=4, radius=-200.0, thickness=90.0,
                     surface_type="forbes_q2d", norm_radius=12.0,
                     terms=((0, 0), (1, 0), (0, 1), (1, 1), (2, 1), (3, 1),
                            (0, 2), (0, -3)),
                     coefficients=[6e-4, -3e-4, 2e-4, -1e-4, 8e-5, -5e-5,
                                   1.5e-4, 1e-4])
    lens.add_surface(index=5)
    lens.set_aperture(aperture_type="EPD", value=20.0)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0)
    lens.add_field(y=2)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens


def _telecentric_singlet(optic):
    """An object-space telecentric N-BK7 singlet at a finite object: object
    NA 0.1, object heights 0 and 5 mm, 0.55 um, the image plane placed by
    ``image_solve``; the small system of the launch-mode kernel checks."""
    lens = optic(name="telecentric singlet")
    lens.add_surface(index=0, radius=math.inf, thickness=80.0)
    lens.add_surface(index=1, radius=60.0, thickness=8.0, material="N-BK7",
                     is_stop=True)
    lens.add_surface(index=2, radius=-90.0, thickness=60.0)
    lens.add_surface(index=3)
    lens.set_aperture(aperture_type="objectNA", value=0.1)
    lens.set_field_type(field_type="object_height")
    lens.add_field(y=0.0)
    lens.add_field(y=5.0)
    lens.add_wavelength(value=0.55, is_primary=True)
    lens.obj_space_telecentric = True
    lens.image_solve()
    return lens


def freeform_builders(name):
    """(JAX builder, port builder) of a freeform system: "singlet:<kind>"
    (the JAX kernel suite's singlets, ``chip_smoke.FREEFORM_KW``),
    "bench:cheb" and
    "bench:zernike" (the JAX bench's freeform singlets), "concentrator",
    "newton_stack", "leaves_stack" or "fresnel_stack"."""
    kind, _, arg = name.partition(":")
    make = {"singlet": lambda o: freeform_singlet(arg, o),
            "bench": lambda o: bench_freeform(arg, o),
            "concentrator": lambda o: zoned_concentrator(o),
            "newton_stack": _newton_stack,
            "leaves_stack": _leaves_stack,
            "fresnel_stack": _fresnel_stack}[kind]
    return (lambda: make(JOptic)), (lambda: make(TOptic))


def jax_combined():
    return _combined(JOptic, jcoatings, japertures)


def torch_combined():
    return _combined(TOptic, tcoatings, tapertures)


def _widened(name):
    """The JAX suite's builder of a system the port carries as a sample."""
    import test_pallas_widened as w
    return {"TiltedSinglet": w._tilted_singlet,
            "CoatedSinglet": w._coated_singlet,
            "OddAsphereSinglet": w._odd_asphere_singlet}[name]


def builders(name):
    """(JAX builder, port builder) of the sample ``name``; "BenchtopHubble"
    is the Hubble telescope scaled by 0.02 with its primary's conic at -0.90
    (the JAX gradient suite's construction, tests/test_pallas_grad.py:
    92-112)."""
    if name == "BenchtopHubble":
        def benchtop(build):
            def make():
                lens = build()
                lens.scale_system(0.02)
                lens.set_conic(-0.90, 2)
                return lens
            return make
        return (benchtop(jsamples.HubbleTelescope),
                benchtop(tsamples.HubbleTelescope))
    if name == "TIRSinglet":
        return jax_tir_singlet, tsamples.TIRSinglet
    if name == "Combined":
        return jax_combined, torch_combined
    if name == "Singlet":
        return (lambda: _singlet(JOptic)), (lambda: _singlet(TOptic))
    if name == "TelecentricSinglet":
        return ((lambda: _telecentric_singlet(JOptic)),
                (lambda: _telecentric_singlet(TOptic)))
    if name == "TiltedImageSinglet":
        return ((lambda: _tilted_image_singlet(JOptic)),
                (lambda: _tilted_image_singlet(TOptic)))
    if name in ("TiltedSinglet", "CoatedSinglet", "OddAsphereSinglet"):
        return _widened(name), getattr(tsamples, name)
    return getattr(jsamples, name), getattr(tsamples, name)


# the launch states of the polarized systems: linear along x, circular
# (Ey a quarter wave behind), and the unpolarized average
POLARIZATION_STATES = {"linear": dict(is_polarized=True, Ex=1.0, Ey=0.0),
                       "circular": dict(is_polarized=True, Ex=1.0, Ey=1.0,
                                        phase_y=math.pi / 2),
                       "unpolarized": None}


def polarized_builders(name, state="linear"):
    """(JAX builder, port builder) of the polarized system ``name``: the
    JAX package's polarized double Gauss ("DoubleGauss",
    examples/double_gauss_polarized.py), the JAX gradient suite's coated
    doublet ("Doublet") or its kernel suite's coated mirror relay
    ("MirrorRelay"), with the launch ``state`` of
    ``POLARIZATION_STATES``."""
    from optiland_pr_tpu.core.polarization import PolarizationState as JPS
    from optiland_pr_tpu_torch.core.polarization import \
        PolarizationState as TPS
    kw = POLARIZATION_STATES[state]
    js, ts = ("unpolarized", "unpolarized") if kw is None else \
        (JPS(**kw), TPS(**kw))
    build = {"DoubleGauss": polarized_double_gauss,
             "Doublet": polarized_doublet, "MirrorRelay": mirror_relay}[name]
    return (lambda: build(JOptic, js)), (lambda: build(TOptic, ts))


def jax_flags_as_port(flags) -> tuple:
    """The JAX package's kernel flags (is_plane, is_refl, absorbing, gkind,
    nu, nv, has_cs, has_ap, coat, gextra, inter) as the port's: the fields
    of the ported sub-slices, (is_plane, is_refl, absorbing, gkind, nu,
    has_cs, has_ap, coat, nv, gextra)."""
    return tuple(SurfaceFlags(f[0], f[1], f[2], f[3], _port_nu(f), f[6], f[7],
                              f[8], f[5], f[9]) for f in flags)


def _port_nu(f):
    """The port's nu of a JAX flag tuple: a Q2D surface counts its
    basis-changed coefficients (the JAX package its (n, m) terms)."""
    return _q2d_count(f[9]) if f[3] == "q2d" else f[4]


class _Captured(Exception):
    pass


def jax_tables(jmodel, jparams, wls, fields, **kw):
    """The (gen, consts, acoef, flags) the JAX entry point
    ``pallas_gen_trace_conic`` hands its kernel for float32 parameters, the
    wavelengths ``wls`` and the fields (0, Hy) for Hy in ``fields``, and
    the entry point's further options ``kw`` (``opd_split=True`` measures
    surface 1's gap from the launch plane); the call stops there, before
    the kernel runs."""
    seen = {}

    def capture(gen, consts, acoef, Px, Py, **kw):
        seen.update(gen=gen, consts=consts, acoef=acoef, flags=kw["flags"])
        raise _Captured

    orig = jpt._pallas_gen_trace_2d
    jpt._pallas_gen_trace_2d = capture
    try:
        jpt.pallas_gen_trace_conic(
            jmodel, jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float32), jparams),
            jnp.zeros(128, jnp.float32), jnp.zeros(128, jnp.float32),
            jnp.asarray(wls, jnp.float32),
            Hx=jnp.zeros(len(fields), jnp.float32),
            Hy=jnp.asarray(fields, jnp.float32), final_prop=True, **kw)
    except _Captured:
        pass
    finally:
        jpt._pallas_gen_trace_2d = orig
    return seen
