"""Builders of the same lens in the JAX package and in the port, and the
JAX kernel tables and flags in the port's terms, for the
``tests/test_torch_*.py`` comparisons."""
import math

import jax
import jax.numpy as jnp

import optiland_pr_tpu.kernels.pallas_trace as jpt
import optiland_pr_tpu.samples as jsamples
import optiland_pr_tpu_torch.samples as tsamples
from optiland_pr_tpu.system import apertures as japertures
from optiland_pr_tpu.system import coatings as jcoatings
from optiland_pr_tpu.system.optic import Optic as JOptic
from optiland_pr_tpu_torch.system import apertures as tapertures
from optiland_pr_tpu_torch.system import coatings as tcoatings
from optiland_pr_tpu_torch.system.optic import Optic as TOptic


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
    if name in ("TiltedSinglet", "CoatedSinglet", "OddAsphereSinglet"):
        return _widened(name), getattr(tsamples, name)
    return getattr(jsamples, name), getattr(tsamples, name)


def jax_flags_as_port(flags) -> tuple:
    """The JAX package's kernel flags (is_plane, is_refl, absorbing, gkind,
    nu, nv, has_cs, has_ap, coat, gextra, inter) as the port's: the fields
    of the ported sub-slices, (is_plane, is_refl, absorbing, gkind, nu,
    has_cs, has_ap, coat)."""
    return tuple((f[0], f[1], f[2], f[3], f[4], f[6], f[7], f[8])
                 for f in flags)


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
