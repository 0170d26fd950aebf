"""K1 in the port: fused ray generation + surface stack + image propagation
(counterpart of ``optiland_pr_tpu/kernels/pallas_trace.py::_pallas_gen_trace_2d``
and its entry point ``pallas_gen_trace_conic``), sub-slices (a), (b), (c),
(d), (e), (f), (g) and (h):
- (a) conic and plane surfaces that refract or reflect, with absorption in
  the pre-material;
- (b) tilted and decentered surfaces (localize before the intersection,
  globalize after the interaction), radial and offset-radial apertures
  (intensity masking in the local frame) and simple coatings (an intensity
  factor after the interaction);
- (c), the Newton sags (even and odd aspheres, the XY polynomial, the
  Chebyshev grid, the biconic, the toroid, the Zernike sag and the Forbes
  Qbfs and Q2D sags on basis-changed coefficients): the conic root as a
  warm start, exactly ``NEWTON_ITERS`` Newton steps without gradient, then
  one differentiable step (its gradient is the implicit-function-theorem
  one); and the two thin Fresnel surfaces, met at
  their base plane, which refract with the parent conic's slope
  ("fresnel_zone") or with the designed facet slope
  m = -sin t / (n_design - cos t), tan t = r / f ("fresnel_designed");
- (d), the launch modes: the object-space telecentric aim x1 = Px*B + x0
  at the constant axial distance sqrt(1 - sin_u^2) / sin_u, and the seven
  closed-form apodizations on the launch intensity (gen columns 10-15,
  ``LAUNCH_COLUMNS``, read at run time in every variant);
- (e), polarization: a polarized launch (``model.polarization`` other than
  "ignore", ``polar_launch``) carries one or two real E-vectors per ray
  through the refract/reflect step of every surface, by the surface's
  rank-structured Jones update (a Fresnel coating's real s/p coefficients,
  or the bare rotation from k0 to k1), and the final intensity is their
  scaled squared norm; the vectors are not rotated by the tilts, and the
  intensity replaces the aperture, coating and absorption factors, as the
  JAX kernel's do;
- (f), the diffractive surfaces, on conic or plane substrates without a
  coating: the linear grating's closed-form diffraction (the groove tangent
  normalize(1, tan a, dfdx + tan a dfdy), the grating vector -normalize(n x
  t), the strength m lambda / period (column 24, per wavelength) scaled by
  the grating vector's xy projection, the normal part rebuilt from |k_out|
  = n2, a ray with no propagating order lost), and the phase update of the
  constant, radial and linear-grating profiles (the profile's
  surface-projected gradient added to the tangential wavevector, the
  normal part rebuilt from n2 k0, an evanescent order's intensity set to
  0, the OPD shifted by -phase / k0, the intensity scaled by the
  efficiency, column 29); neither updates a polarized launch's E-vectors;
- (g), the OPD precision modes (``OPD_MODES``): "kahan", the compensated
  sum of the path lengths, and "split", the split-OPD accumulation of
  untilted conic/plane stacks (``supports_split_opd``): z is carried local
  to the previous vertex, only the sag-scale deviation of each surface's
  path from its axial gap enters the per-ray (compensated) sum, and the
  axial base, identical for every ray, is returned beside the rays;
- (h), the coord_split mode ("xy", ``supports_split_xy``: the split mode's
  surfaces, unpolarized, simple or no coatings): the whole ray state in
  float64 (the JAX kernel's two-float arithmetic is a TPU workaround) with
  the split mode's local z, the curvature the sum of columns 0 and 28, the
  OPD output each ray's deviation from the chief ray's (the pupil-centre
  ray of each wavelength and field), whose own OPD is returned beside the
  rays; in its own libraries, ``csrc/gen_trace_xy.cu`` and
  ``csrc/gen_grad_xy.cu``.

The module holds
- the host plumbing: ``supports_model``, ``gen_eligible``, ``model_flags``,
  ``pack_surface_constants``, ``pack_asphere_coeffs``, ``gen_tables`` and
  ``zernike_table``, with the JAX package's table layout
  (``pallas_trace.py:37-46``);
- ``gen_trace_plain``: the plain PyTorch version of the kernel on the packed
  tables, in the kernel's operation order;
- ``gen_trace_cuda``: the wrapper of the hand-written CUDA kernel
  ``csrc/gen_trace.cu`` (its polarized instances in a library of their own,
  ``csrc/gen_trace_pol.cu``), built with nvcc at first use and bound with
  ctypes;
- ``build_kernel``/``build_kernels``: the nvcc build of the port's CUDA
  sources (K1 here, K2, one library per OPD mode, in ``gen_grad.py``, each
  with a polarized library beside it, and in the plain and Kahan modes the
  libraries of the systems with a grating or phase surface, K3 in
  ``trace_conic.py``, K4 in ``huygens.py``);
- ``gen_trace_conic``, the counterpart of ``pallas_gen_trace_conic``: a CPU
  tensor takes the plain version, a CUDA tensor the kernel, and nothing
  falls back. Inputs that require grad go through ``gen_grad.GenTrace``,
  whose backward is K2.

Outputs are [8, W, F, n] float32 (x, y, z, L, M, N, intensity, opd) in
(wavelength, field, pupil) order.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.rays import Rays
from ..core.transforms import rotation_matrix
from ..geometry.forbes import (abc_q2d, clenshaw_q2d, clenshaw_q2d_der,
                               q2d_basis_matrix, q2d_layout, q2d_sum,
                               qbfs_basis_matrix, qbfs_sum)
from ..system.model import OpticModel, positions_from_params

__all__ = ["supports_model", "supports_split_opd", "supports_split_xy",
           "gen_eligible", "xy_takes", "gen_trace_xy_cuda",
           "model_flags", "NEWTON_ITERS", "OPD_MODES", "GRAD_LIBS",
           "GRAD_POL_LIBS", "grad_lib", "has_doe",
           "ZERNIKE_BASES", "VARIANTS", "SurfaceFlags", "zernike_table",
           "n_coefs",
           "pack_surface_constants", "pack_asphere_coeffs", "gen_tables",
           "gen_trace_plain", "gen_trace_cuda", "gen_trace_conic",
           "PolarLaunch", "polar_launch",
           "split_consts", "axial_base", "check_tables", "build_kernel",
           "build_kernels", "BUILD_LOG"]

CONST_W = 32       # per-surface constant row width
GEN_W = 16         # per-field launch row width
MAX_SURFACES = 64  # the kernel's static flag table (csrc/gen_trace.cu)
# gen columns 10-15, the launch mode: the telecentric flag, the
# apodization code (system/apodization.py::APOD_KINDS) and its constants
LAUNCH_COLUMNS = ("telecentric", "apod_code", "apod_p0", "apod_p1",
                  "apod_p2", "apod_p3")
MAX_TERMS = 32     # sag coefficients a surface may carry (csrc/gen_grad.cu)
Q2D_ROWS = 4       # a Q2D surface's structure rows in acoef (q2d_structure)
NEWTON_ITERS = 8   # fixed Newton refinements of an asphere intersection
_EPS = 1e-14
# pi and 2 pi as the apodization profiles multiply by them: rounded to
# float32 (a float32 product with a Python float)
_PI_F = float(np.float32(math.pi))
_TWO_PI_F = float(np.float32(2 * math.pi))
# the kernels' OPD modes (csrc/gen_trace_common.cuh: OPD_PLAIN, OPD_KAHAN,
# OPD_SPLIT; "xy", the coord_split mode of sub-slice (h), is a library of
# its own, csrc/gen_trace_xy.cu), by their integer codes
OPD_MODES = ("plain", "kahan", "split", "xy")

# the flag word of a surface (csrc/gen_trace_common.cuh): bits 0-5 the
# booleans, bits 6-9 the sag kind, bits 10-15 nu (the terms of a sag, the
# x size of a coefficient grid, a radial phase profile's terms), bits 16-21
# nv (a grid's y size), bits 22-23 the Zernike basis, bit 24 a Fresnel
# coating (read by a polarized launch only); sub-slice (f): bits 25-26 the
# interaction (INTERACTIONS), bits 27-28 a phase surface's profile
# (PHASE_KINDS), bit 29 a phase surface on the Plane class (+z normal)
FLAG_PLANE, FLAG_REFL, FLAG_ABSORB = 1, 2, 4
FLAG_CS, FLAG_AP, FLAG_COAT = 8, 16, 32
FLAG_FRESNEL = 1 << 24
INTER_SHIFT, PHASE_SHIFT, FLAG_PLANE_CLS = 25, 27, 1 << 29
INTERACTIONS = ("refract_reflect", "grating", "phase")
PHASE_KINDS = ("constant", "radial", "linear_grating")
# a phase surface's diffraction efficiency (a static float in the JAX
# kernel): a constant column no gradient reaches
EFF_COL = 29
# a polarized launch's fallback of the s basis: below |k0 x n|^2 = 1e-12
# (normal incidence) s = k0 x (1, 0, 0) (pallas_trace.py:744-749)
POL_FALLBACK = 1e-12
GKIND_SHIFT, NU_SHIFT, NV_SHIFT, BASIS_SHIFT = 6, 10, 16, 22
GKIND_MASK, NTERM_MASK, BASIS_MASK = 15, 63, 3
_GKIND_CODES = {"conic": 0, "even": 1, "odd": 2, "poly": 3, "cheb": 4,
                "biconic": 5, "toroidal": 6, "toroidal_inf": 7,
                "zernike": 8, "fresnel_zone": 9, "fresnel_designed": 10,
                "qbfs": 11, "q2d": 12}
_KERNEL_KINDS = {"standard": "conic", "plane": "conic",
                 "even_asphere": "even", "odd_asphere": "odd",
                 "polynomial_xy": "poly", "chebyshev": "cheb",
                 "biconic": "biconic", "toroidal": "toroidal",
                 "zernike": "zernike", "fresnel_zone": "fresnel_zone",
                 "fresnel_designed": "fresnel_designed",
                 "forbes_qbfs": "qbfs", "forbes_q2d": "q2d",
                 "standard_grating": "conic", "plane_grating": "conic"}
FRESNEL_KINDS = ("fresnel_zone", "fresnel_designed")
# the kernels' variants (csrc/gen_trace_common.cuh: VAR_NARROW, VAR_WIDE,
# VAR_FREEFORM, VAR_FORBES), by the codes the launchers report: sub-slice
# (a); with (b) and the even/odd aspheres; with the other sags of (c) but
# the Forbes sags; with the Forbes sags too. The launchers pick the variant
# (variant_of) and the wrappers count what they report
VARIANTS = ("narrow", "wide", "freeform", "forbes")
# the Zernike bases by their codes in the flag word
ZERNIKE_BASES = ("standard", "fringe", "noll")
ZT_W = 32          # floats per term of the Zernike table (zernike_table)

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"


# ---------------------------------------------------------------------------
# eligibility and static flags
# ---------------------------------------------------------------------------

def n_coefs(gkind: str, nu: int, nv: int) -> int:
    """Coefficients a surface's sag reads from its ``acoef`` row: the
    nu x nv grid of the XY polynomial and the Chebyshev sag, else nu."""
    return nu * nv if gkind in ("poly", "cheb") else nu


def acoef_width(gkind: str, nu: int, nv: int) -> int:
    """Columns of its ``acoef`` row a surface's sag reads: its
    coefficients, and for a Q2D surface the term structure behind them
    (``Q2D_ROWS`` rows of nu, ``q2d_structure``)."""
    return (1 + Q2D_ROWS) * nu if gkind == "q2d" else n_coefs(gkind, nu, nv)


def _sag_shape(spec) -> tuple:
    """(nu, nv) of a surface's geometry: its terms, or its coefficient
    grid; a Q2D surface's nu counts its basis-changed coefficients
    (``q2d_layout``), which gaps in its (n, m) terms make more than its
    terms; a radial phase surface's nu its profile's terms."""
    prof = spec.phase_profile
    if spec.interaction == "phase" and prof is not None \
            and prof.kind == "radial":
        return prof.num_terms, 0
    geom = spec.geometry
    if geom.kind in ("polynomial_xy", "chebyshev"):
        return geom.num_x, geom.num_y
    if geom.kind == "forbes_q2d":
        return _q2d_count(geom.terms), 0
    return getattr(geom, "num_terms", 0), 0


def supports_model(model: OpticModel) -> bool:
    """True if every inner surface is in the ported sub-slices: a conic,
    plane, even- or odd-aspheric, XY-polynomial, Chebyshev, biconic,
    toroidal, Zernike, Forbes Qbfs or Q2D or thin Fresnel surface that
    refracts or reflects, a linear grating on a conic or plane
    (``standard_grating``, ``plane_grating``) without a coating, or a conic
    or plane phase surface with a constant, radial or linear-grating
    profile (``PHASE_KINDS``; a grid profile stays on the eager trace)
    without a coating (``pallas_trace.py:80-125``); tilted or not, with no
    aperture or a radial or offset-radial one, no coating, a simple or a
    Fresnel one, at most ``MAX_TERMS`` sag coefficients (a Q2D surface:
    basis-changed ones, of orders |m| up to ``MAX_TERMS``; a radial phase
    profile: terms), and the stack fits the kernel's flag table. A Fresnel
    coating acts on a polarized launch's E-vectors (sub-slice (e)) and
    leaves an unpolarized one as it is."""
    if model.num_surfaces - 1 > MAX_SURFACES:
        return False
    for spec in model.surfaces[1:]:
        kind = spec.geometry.kind
        if spec.interaction == "grating":
            if kind not in ("standard_grating", "plane_grating") \
                    or spec.coating is not None:
                return False
        elif spec.interaction == "phase":
            prof = spec.phase_profile
            if (kind not in ("standard", "plane") or prof is None
                    or prof.kind not in PHASE_KINDS
                    or spec.coating is not None):
                return False
        elif spec.interaction != "refract_reflect" \
                or kind not in _KERNEL_KINDS:
            return False
        nu, nv = _sag_shape(spec)
        if (max(nu, nv) > NTERM_MASK or n_coefs(
                _KERNEL_KINDS[spec.geometry.kind], nu, nv) > MAX_TERMS):
            return False
        if spec.geometry.kind == "forbes_q2d" and \
                spec.geometry.max_m > MAX_TERMS:
            return False
        if spec.aperture is not None and spec.aperture.kind not in (
                "radial", "offset_radial"):
            return False
        if spec.coating is not None and spec.coating.kind not in ("simple",
                                                                  "fresnel"):
            return False
    return True


def supports_split_opd(model: OpticModel) -> bool:
    """True when the split-OPD mode applies (``pallas_trace.py:145-156``):
    an untilted stack of conic and plane surfaces that refract or reflect
    (no grating or phase surface); apertures and simple coatings are
    allowed (the gap-path decomposition assumes per-surface z frames and
    axial propagation signs)."""
    return supports_model(model) and all(
        spec.geometry.kind in ("standard", "plane")
        and spec.interaction == "refract_reflect"
        and not spec.has_tilt_decenter for spec in model.surfaces[1:])


def supports_split_xy(model: OpticModel) -> bool:
    """True when the coord_split mode of sub-slice (h) applies
    (``pallas_trace.py:159-172``): the split-OPD scope, an unpolarized
    launch, and every coating simple or absent."""
    return supports_split_opd(model) and model.polarization == "ignore" \
        and all(spec.coating is None or spec.coating.kind == "simple"
                for spec in model.surfaces[1:])


def gen_eligible(model: OpticModel) -> bool:
    """Launch modes the fused generation covers: origin x0 = Px*A + xf aimed
    at x1 = Px*B on the entrance-pupil plane (angle fields, finite-object
    object-height fields, paraxial-image-height fields), or the telecentric
    aim x1 = Px*B + x0 at the constant axial distance sqrt(1 - sin_u^2) /
    sin_u, which needs a finite object (``pallas_trace.py:136``)."""
    if model.obj_space_telecentric and model._object_infinite:
        return False
    if model.field_type == "angle":
        return True
    if model.field_type == "object_height":
        return not model._object_infinite
    return model.field_type == "paraxial_image_height"


def _hint_isinf(spec, params, k, key: str) -> bool:
    """The host-side hint ``Optic.build`` stamps for ``key`` (a geometry's
    ``<key>_is_inf``); a geometry without it is read from ``params``."""
    hint = getattr(spec.geometry, f"{key}_is_inf", None)
    if hint is None:
        hint = bool(torch.isinf(params["surfaces"][k]["geom"][key]).item())
    return bool(hint)


class SurfaceFlags(NamedTuple):
    """Static flags of an inner surface, the JAX package's fields of this
    scope (``pallas_trace.py::model_flags``) in the port's order. gkind is
    "conic", "even", "odd", "poly", "cheb", "biconic", "toroidal",
    "toroidal_inf" (an infinite rotation radius), "zernike", "qbfs", "q2d",
    "fresnel_zone" or "fresnel_designed"; nu the number of sag coefficients
    (``n_coefs``; a Q2D surface's basis-changed ones; a radial phase
    profile's terms) or the x size of a coefficient grid, nv its y size
    (else 0); coat "none", "simple" or "fresnel"; gextra the Zernike basis
    or the Q2D (n, m) terms (else None); inter the interaction of
    sub-slice (f): None (refract or reflect), ("grating",) or ("phase",
    profile kind, on the Plane class) (the JAX descriptor without the
    efficiency, which column ``EFF_COL`` carries)."""
    is_plane: bool
    is_refl: bool
    absorbing: bool
    gkind: str
    nu: int
    has_cs: bool
    has_ap: bool
    coat: str
    nv: int = 0
    gextra: Optional[str] = None
    inter: Optional[tuple] = None


def model_flags(model: OpticModel, params=None) -> tuple:
    """``SurfaceFlags`` per inner surface. ``is_plane`` and a toroid's
    infinite rotation radius are read from the host-side hints
    ``radius_is_inf``/``radius_rot_is_inf`` (stamped by ``Optic.build``); a
    geometry without them is read from ``params``."""
    flags = []
    for k in range(1, model.num_surfaces):
        spec = model.surfaces[k]
        is_plane = _hint_isinf(spec, params, k, "radius")
        pre = model.surfaces[k - 1]
        absorbing = model.surfaces[pre.material_src].material.absorbing
        gkind = _KERNEL_KINDS[spec.geometry.kind]
        inter = {"grating": ("grating",),
                 "phase": ("phase", getattr(spec.phase_profile, "kind", None),
                           spec.geometry.kind == "plane")
                 }.get(spec.interaction)
        nu, nv = _sag_shape(spec) if gkind != "conic" or inter else (0, 0)
        if gkind == "toroidal" and _hint_isinf(spec, params, k, "radius_rot"):
            gkind = "toroidal_inf"
        gextra = {"zernike": getattr(spec.geometry, "zernike_type", None),
                  "q2d": getattr(spec.geometry, "terms", None)}.get(gkind)
        coat = "none" if spec.coating is None else spec.coating.kind
        flags.append(SurfaceFlags(bool(is_plane), bool(spec.is_reflective),
                                  bool(absorbing), gkind, nu,
                                  bool(spec.has_tilt_decenter),
                                  spec.aperture is not None, coat, nv, gextra,
                                  inter))
    return tuple(flags)


def _flag_words(flags) -> list:
    """The kernels' int32 flag word of each surface."""
    words = []
    for (is_plane, is_refl, absorbing, gkind, nu, has_cs, has_ap, coat, nv,
         gextra, *inter) in flags:
        inter = inter[0] if inter else None
        if (coat not in ("none", "simple", "fresnel")
                or gkind not in _GKIND_CODES
                or not 0 <= nu <= NTERM_MASK or not 0 <= nv <= NTERM_MASK
                or n_coefs(gkind, nu, nv) > MAX_TERMS
                or (gkind == "q2d" and (gextra is None or _q2d_count(gextra)
                                        != nu))
                or not _inter_ok(inter, gkind, nu, coat)):
            raise ValueError(f"no kernel for coating {coat!r}, sag "
                             f"{gkind!r} with ({nu}, {nv}) terms or "
                             f"interaction {inter!r}")
        basis = ZERNIKE_BASES.index(gextra) if gkind == "zernike" else 0
        words.append((FLAG_PLANE if is_plane else 0)
                     | (FLAG_REFL if is_refl else 0)
                     | (FLAG_ABSORB if absorbing else 0)
                     | (FLAG_CS if has_cs else 0) | (FLAG_AP if has_ap else 0)
                     | (FLAG_COAT if coat == "simple" else 0)
                     | (FLAG_FRESNEL if coat == "fresnel" else 0)
                     | (_GKIND_CODES[gkind] << GKIND_SHIFT)
                     | (nu << NU_SHIFT) | (nv << NV_SHIFT)
                     | (basis << BASIS_SHIFT) | _inter_bits(inter))
    return words


def _inter_ok(inter, gkind: str, nu: int, coat: str) -> bool:
    """Whether the kernels take a surface's interaction descriptor: a
    grating or phase surface is conic or plane and uncoated, a phase
    profile one of ``PHASE_KINDS``, and only a radial one has terms."""
    if inter is None:
        return True
    if gkind != "conic" or coat != "none":
        return False
    if inter[0] == "grating":
        return len(inter) == 1 and nu == 0
    return (inter[0] == "phase" and len(inter) == 3
            and inter[1] in PHASE_KINDS and (nu == 0 or inter[1] == "radial"))


def _inter_bits(inter) -> int:
    """The flag-word bits of an interaction descriptor."""
    if inter is None:
        return 0
    bits = INTERACTIONS.index(inter[0]) << INTER_SHIFT
    if inter[0] == "phase":
        bits |= PHASE_KINDS.index(inter[1]) << PHASE_SHIFT
        bits |= FLAG_PLANE_CLS if inter[2] else 0
    return bits


def _q2d_count(terms) -> int:
    """The basis-changed coefficients of a Q2D term list."""
    n_m0, len_a, len_b = q2d_layout(terms)
    return n_m0 + sum(len_a) + sum(len_b)


@functools.lru_cache(maxsize=None)
def q2d_structure(terms: tuple) -> tuple:
    """The term structure of a Q2D surface behind its basis-changed
    coefficients, as the kernels read it from the ``acoef`` row after the
    coefficients (``Q2D_ROWS`` rows of nu floats): per coefficient j, in
    the packed order ([m = 0 | cosine m = 1 | sine m = 1 | ...], each group
    in ascending n), its group's code (0 for the rotational group, 2 m for
    cosine, 2 m + 1 for sine) and the Pnm recurrence's a(n, m), b(n, m) and
    c(n + 1, m) at its n (zero where the recurrence does not read them).
    Float64 Python numbers; the CUDA table holds them rounded to float32,
    as the plain version's float32 products round them."""
    n_m0, len_a, len_b = q2d_layout(terms)
    rows = [(0.0, 0.0, 0.0, 0.0)] * n_m0
    for m in range(1, len(len_a)):
        for ln, code in ((len_a[m], 2 * m), (len_b[m], 2 * m + 1)):
            for n in range(ln):
                a, b, _ = abc_q2d(n, m) if n < ln - 1 else (0.0, 0.0, 0.0)
                c = abc_q2d(n + 1, m)[2] if n < ln - 2 else 0.0
                rows.append((float(code), float(a), float(b), float(c)))
    return tuple(tuple(r[i] for r in rows) for i in range(Q2D_ROWS))


@functools.lru_cache(maxsize=None)
def zernike_terms_table(basis: str, num_terms: int) -> tuple:
    """The static structure of the first ``num_terms`` Zernike terms of a
    basis, as both versions of the kernel read it: per term (n, m, the
    normalization, ((p, coef, p * coef) for each power p of its radial
    polynomial, in ascending p)). Float64 Python numbers; the CUDA table
    holds them rounded to float32, as a float32 product rounds them."""
    from ..core.zernike import _norm_factor, _radial_coeffs, zernike_terms
    out = []
    for n, m in zernike_terms(basis, num_terms):
        radial = sorted((p, c, p * c) for p, c in _radial_coeffs(n, m))
        out.append((n, m, _norm_factor(basis, n, m), tuple(radial)))
    return tuple(out)


def zernike_table(device=None) -> torch.Tensor:
    """float32 [3, MAX_TERMS, ZT_W]: the term structure of each basis of
    ``ZERNIKE_BASES`` for the CUDA kernels (csrc/gen_trace_common.cuh), per
    term [n, m, norm, number of powers, then (p, coef, p * coef) per power
    in ascending p], built once per device."""
    return _zernike_table(str(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _zernike_table(device: str) -> torch.Tensor:
    tab = np.zeros((len(ZERNIKE_BASES), MAX_TERMS, ZT_W), np.float32)
    for b, basis in enumerate(ZERNIKE_BASES):
        for j, (n, m, norm, radial) in enumerate(
                zernike_terms_table(basis, MAX_TERMS)):
            if 4 + 3 * len(radial) > ZT_W:
                raise ValueError("a Zernike term exceeds the table's width")
            tab[b, j, :4] = (n, m, norm, len(radial))
            tab[b, j, 4:4 + 3 * len(radial)] = np.ravel(radial)
    return torch.as_tensor(tab, device=device)


# ---------------------------------------------------------------------------
# table packing
# ---------------------------------------------------------------------------

def _pack_surface(model: OpticModel, params, k: int, wls, pos):
    """[W, 32] constant rows of surface k for the wavelengths ``wls`` [W]."""
    spec = model.surfaces[k]
    sp = params["surfaces"][k]
    ref = sp["thickness"]
    W = wls.shape[0]

    def col(v):
        return torch.as_tensor(v, dtype=ref.dtype, device=ref.device
                               ).reshape(-1).expand(W)

    radius = sp["geom"]["radius"]
    conic = sp["geom"]["conic"]
    is_plane = torch.isinf(radius)
    radius_inv = torch.where(is_plane, 0.0, 1.0 / radius)
    # column 28: the low word of 1/R against its float32-rounded high word
    # (the two-float curvature of the coord_split mode); float32 parameters
    # make the f64 product below exact
    rih = radius_inv.to(torch.float32).to(torch.float64)
    rsafe = torch.where(is_plane, 1.0, radius).to(torch.float64)
    radius_inv_lo = torch.where(is_plane, 0.0, (1.0 - rih * rsafe) / rsafe)

    pre = model.surfaces[k - 1]
    mat1 = model.surfaces[pre.material_src].material
    mp1 = params["surfaces"][pre.material_src]["material"]
    n1 = mat1.n(mp1, wls)
    # a grating reads its post material even when reflective (a mirror's
    # post material is its pre material anyway)
    if spec.is_reflective and spec.interaction != "grating":
        n2 = n1
    else:
        n2 = model.surfaces[spec.material_src].material.n(
            params["surfaces"][spec.material_src]["material"], wls)
    alpha = 4.0 * math.pi * mat1.k(mp1, wls) / wls if mat1.absorbing else 0.0

    # column 6: the simple coating's intensity factor
    coat = 1.0
    if spec.coating is not None and spec.coating.kind == "simple":
        coat = spec.coating.intensity_factor(sp["coating"], spec.is_reflective)

    # columns 8-16: the rotation, row-major; 17-19: tx, ty, pos_z + dz
    if spec.has_tilt_decenter:
        cs = sp["cs"]
        rot = list(rotation_matrix(cs["rx"], cs["ry"], cs["rz"]).reshape(-1))
        tvec = [cs["dx"], cs["dy"], pos[k] + cs["dz"]]
    else:
        rot, tvec = [0.0] * 9, [0.0] * 3

    # columns 20-23: r_min^2, r_max^2 and the offset; the double where keeps
    # an unbounded r_max (inf squared) from putting 0 x inf = NaN into the
    # extents' cotangent
    if spec.aperture is not None:
        ap = sp["aperture"]

        def sq(r):
            fin = torch.isfinite(r)
            return torch.where(fin, torch.where(fin, r, 1.0) ** 2, math.inf)
        apr = [sq(ap["r_min"]), sq(ap["r_max"]), ap.get("offset_x", 0.0),
               ap.get("offset_y", 0.0)]
    else:
        apr = [0.0, math.inf, 0.0, 0.0]

    # columns 24-25: the sag's own scalars (pallas_trace.py:236-252)
    gp = sp["geom"]
    extra = {"chebyshev": lambda: [gp["norm_x"], gp["norm_y"]],
             "biconic": lambda: [torch.where(
                 torch.isinf(gp["radius_x"]), 0.0, 1.0 / gp["radius_x"]),
                 gp["conic_x"]],
             "toroidal": lambda: [torch.where(
                 torch.isinf(gp["radius_rot"]), 1.0, gp["radius_rot"]), 0.0],
             "zernike": lambda: [gp["norm_radius"], 0.0],
             "forbes_qbfs": lambda: [gp["norm_radius"], 0.0],
             "forbes_q2d": lambda: [gp["norm_radius"], 0.0],
             "fresnel_designed": lambda: [gp["focal_length"],
                                          gp["n_design"]]}
    g24 = extra.get(spec.geometry.kind, lambda: [0.0, 0.0])()
    # sub-slice (f): a grating's strength m lambda / period (both um) per
    # wavelength and tan of its groove angle; a phase surface's constant
    # phase, or its linear grating's (Kx, Ky) (a radial profile's terms
    # ride the acoef row); its efficiency in column 29
    eff = 0.0
    if spec.interaction == "grating":
        g24 = [gp["grating_order"] * wls / gp["grating_period"],
               torch.tan(gp["groove_angle"])]
    elif spec.interaction == "phase":
        pp, prof = sp["phase"], spec.phase_profile
        g24 = {"constant": lambda: [pp["phase"], 0.0],
               "linear_grating": lambda: list(prof._K(pp))}.get(
                   prof.kind, lambda: [0.0, 0.0])()
        eff = float(prof.efficiency)

    # column 27: the signed vertex gap (the split-OPD mode reads it;
    # surface 1's is measured from the launch plane by gen_trace_conic)
    dz_gap = pos[k] - pos[k - 1]
    dz_gap = torch.where(torch.isfinite(dz_gap), dz_gap, 0.0)
    cols = ([radius_inv, conic, pos[k], n1, n2, alpha, coat, wls]
            + rot + tvec + apr
            + g24 + [0.0, dz_gap, radius_inv_lo, eff, 0.0, 0.0])
    return torch.stack([col(v) for v in cols], dim=-1)


def pack_surface_constants(model: OpticModel, params, wavelength):
    """float32 [S-1, 32] constants for a scalar wavelength, or [W, S-1, 32]
    for a 1-D tensor of W wavelengths (``pallas_trace.py::_pack_rows``), for
    a system ``supports_model`` accepts."""
    if not supports_model(model):
        raise NotImplementedError("the system has a surface no ported "
                                  "sub-slice covers (supports_model)")
    ref = params["surfaces"][0]["thickness"]
    wl = torch.as_tensor(wavelength, dtype=ref.dtype, device=ref.device)
    wls = torch.atleast_1d(wl)
    pos = positions_from_params(params)
    rows = torch.stack([_pack_surface(model, params, k, wls, pos)
                        for k in range(1, model.num_surfaces)], dim=1)
    rows = rows.to(torch.float32)
    return rows[0] if wl.ndim == 0 else rows


_COEF_LEAVES = {"even_asphere": "coefficients", "odd_asphere": "coefficients",
                "polynomial_xy": "coefficients", "chebyshev": "coefficients",
                "toroidal": "coeffs_poly_y", "zernike": "coefficients"}


def _forbes_coeff_vector(geom, gp):
    """A Forbes surface's coefficients through the Qbfs -> Pn and Q2D -> Pnm
    basis changes, in float32 (``pallas_trace.py::_geom_coeff_vector``
    :341-348, ``_q2d_packed_coeffs`` :352), so that the kernel's Clenshaw
    sums work on the Pn/Pnm expansion; a Q2D surface's is followed by its
    term structure (``q2d_structure``). Differentiable."""
    c = gp["coefficients"].to(torch.float32)

    def basis(M, v):
        return torch.as_tensor(M, dtype=torch.float32, device=c.device) @ v
    if geom.kind == "forbes_qbfs":
        n = geom.num_terms
        return basis(qbfs_basis_matrix(n), c[:n]) if n else None
    cm0, ams, bms = geom.grouped(c)
    parts = []
    if cm0:
        parts.append(basis(qbfs_basis_matrix(len(cm0)), torch.stack(cm0)))
    for m in range(1, geom.max_m + 1):
        for coefs in (ams[m], bms[m]):
            if coefs:
                parts.append(basis(q2d_basis_matrix(len(coefs), m),
                                   torch.stack(coefs)))
    if not parts:
        return None
    table = torch.tensor(q2d_structure(geom.terms), dtype=torch.float32,
                         device=c.device).reshape(-1)
    return torch.cat(parts + [table])


def pack_asphere_coeffs(model: OpticModel, params):
    """float32 [S-1, C] geometry coefficients, zero-padded, C at least 8 and
    a multiple of 8 (``pallas_trace.py::pack_asphere_coeffs`` and
    ``_geom_coeff_vector``): the even or odd asphere's terms, the XY
    polynomial's and the Chebyshev sag's grids row-major (C[i, j] at
    i * nv + j), the toroid's y-polynomial, the Zernike coefficients,
    the Forbes surfaces' basis-changed ones (``_forbes_coeff_vector``) and
    a radial phase profile's coefficients; other surfaces carry none. The
    packing is differentiable, so coefficient gradients flow back into the
    tree."""
    ref = params["surfaces"][0]["thickness"]
    vecs = []
    for k in range(1, model.num_surfaces):
        spec = model.surfaces[k]
        geom = spec.geometry
        leaf = _COEF_LEAVES.get(geom.kind)
        v = None
        if _sag_shape(spec)[0] and spec.interaction == "phase":
            v = params["surfaces"][k]["phase"]["coefficients"].to(
                torch.float32).reshape(-1)
        elif leaf is not None:
            v = params["surfaces"][k]["geom"][leaf].to(
                torch.float32).reshape(-1)
            v = v if v.shape[0] else None
        elif geom.kind in ("forbes_qbfs", "forbes_q2d"):
            v = _forbes_coeff_vector(geom, params["surfaces"][k]["geom"])
        vecs.append(v)
    cmax = max([8] + [v.shape[0] for v in vecs if v is not None])
    cmax = ((cmax + 7) // 8) * 8
    zero = torch.zeros((cmax,), dtype=torch.float32, device=ref.device)
    return torch.stack([zero if v is None else
                        torch.nn.functional.pad(v, (0, cmax - v.shape[0]))
                        for v in vecs])


def gen_tables(model: OpticModel, params, wavelength, Hx=0.0, Hy=0.0,
               apodization=None):
    """(gen [F, 16], consts [W, S-1, 32], acoef [S-1, C]), all float32,
    for the fields (Hx, Hy) (scalars or 1-D) and the wavelength(s).

    Vignetting folds into the half-EPD terms; the field coordinates are
    rounded to float32 first, as the JAX package does. A telecentric
    launch (``pallas_gen_trace_conic``, ``pallas_trace.py:2354-2367``) puts
    the axial aim distance sqrt(1 - sin_u^2) / sin_u in column 5 and the
    vignetting factors in columns 8-9, and sets column 10; an apodization
    (one of ``system/apodization.py``'s profiles) puts its code in column
    11 and its constants in columns 12-15 (``LAUNCH_COLUMNS``)."""
    from ..trace.paraxial import Paraxial
    from ..trace.raygen import _ray_origins, vig_factor

    ref = params["surfaces"][0]["thickness"]
    dt, dev = ref.dtype, ref.device
    wls = torch.atleast_1d(torch.as_tensor(wavelength, dtype=dt, device=dev))
    consts = pack_surface_constants(model, params, wls)

    par = Paraxial(model, params)
    EPL = par.EPL()
    EPD = par.EPD()
    Hxa = torch.atleast_1d(torch.as_tensor(Hx, dtype=torch.float32))
    Hya = torch.atleast_1d(torch.as_tensor(Hy, dtype=torch.float32))
    Hxa, Hya = torch.broadcast_tensors(Hxa.to(dev, dt), Hya.to(dev, dt))
    zero = torch.zeros((), dtype=dt, device=dev)
    launch = _launch_row(model, apodization)
    rows = []
    for f in range(Hxa.shape[0]):
        hx, hy = Hxa[f], Hya[f]
        vxf, vyf = vig_factor(model, params, hx, hy)
        vx = 1.0 - vxf.reshape(())
        vy = 1.0 - vyf.reshape(())
        # the origin is Px*A + xf, so the pupil-centre sample isolates xf
        z1 = torch.zeros((1,), dtype=dt, device=dev)
        x0c, y0c, z0c = _ray_origins(model, params, par, hx, hy, z1, z1,
                                     vx, vy)
        if model._object_infinite:
            ax, ay = EPD / 2 * vx, EPD / 2 * vy
        else:
            ax = ay = zero
        if model.obj_space_telecentric:
            sin_u = params["aperture_value"].reshape(())
            aim = [torch.sqrt(1.0 - sin_u * sin_u) / sin_u, vx, vy]
        else:
            aim = [EPL.reshape(()), (EPD / 2 * vx).reshape(()),
                   (EPD / 2 * vy).reshape(())]
        t_img = params["surfaces"][-1]["thickness"].reshape(())
        rows.append(torch.stack(
            [ax.reshape(()), ay.reshape(()), x0c[0], y0c[0], z0c[0],
             aim[0], t_img, zero, aim[1], aim[2]]
            + [zero + v for v in launch]))
    gen = torch.stack(rows).to(torch.float32)
    return gen, consts, pack_asphere_coeffs(model, params)


def _launch_row(model: OpticModel, apodization) -> list:
    """gen columns 10-15 (``LAUNCH_COLUMNS``): the telecentric flag, the
    apodization's code and its constants, as float64 Python numbers."""
    from ..system.apodization import kernel_apodization
    if not kernel_apodization(apodization):
        raise ValueError("K1 evaluates the closed-form apodizations of "
                         "system/apodization.py only")
    code, consts = (0, ()) if apodization is None else \
        apodization.kernel_params()
    row = [1.0 if model.obj_space_telecentric else 0.0, float(code)]
    row += [float(v) for v in consts]
    return row + [0.0] * (len(LAUNCH_COLUMNS) - len(row))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _sqrt(v):
    """The correctly rounded square root, the kernels' __fsqrt_rn. torch's
    sqrt is correctly rounded on the card but not on the CPU in float32 (up
    to 0.5001 ulp), so there the root is taken in float64 and rounded once,
    which is correctly rounded for a float32 argument."""
    if v.dtype == torch.float32 and v.device.type == "cpu":
        return torch.sqrt(v.double()).float()
    return torch.sqrt(v)


def launch_mode(gen) -> tuple:
    """(telecentric, apodization code) of gen columns 10-11, read on the
    host; every field's row must agree."""
    host = gen[:, 10:12].detach().cpu()
    if not bool((host == host[0]).all()):
        raise ValueError("the fields' launch modes differ")
    return bool(host[0, 0] != 0), int(host[0, 1])


def apod_weight(code: int, p, px, py):
    """The launch intensity of the apodization ``code`` (an index of
    ``system/apodization.py::APOD_KINDS``) at the pupil samples, in the
    kernel's operation order (``csrc/gen_trace_common.cuh::apod_weight``),
    or None for a weight of 1. ``p(j)`` is the profile's constant j (gen
    column 12 + j). The profiles that depend on r = sqrt(Px^2 + Py^2)
    differentiate the root at the pupil centre as the JAX profiles do (NaN
    pupil cotangents there); the polynomial profile's power takes 1 outside
    its support (the double where)."""
    if code <= 1:
        return None
    s2 = px * px + py * py
    if code == 2:                               # Gaussian
        return torch.exp(-s2 / p(0))
    r = _sqrt(s2)
    if code == 3:                               # cosine squared
        c = torch.cos(_PI_F * r / p(0))
        return torch.where(r < p(1), c * c, 0.0)
    if code == 4:                               # Hann
        w = 0.5 * (1.0 - torch.cos(_TWO_PI_F * r / p(0)))
        return torch.where(r < p(1), w, 0.0)
    if code == 5:                               # Tukey
        taper = 0.5 * (1.0 + torch.cos(_PI_F * (r - p(0)) / p(1)))
        out = torch.where(r <= p(0), 1.0, taper)
        return torch.where(r <= p(2), out, 0.0)
    if code == 6:                               # super-Gaussian
        return torch.exp(-torch.pow(r / p(0), p(1)))
    if code == 7:                               # polynomial
        q = r / p(0)
        inside = r < p(0)
        base = torch.where(inside, 1.0 - q * q, 1.0)
        return torch.where(inside, torch.pow(base, p(1)), 0.0)
    raise ValueError(f"unknown apodization code {code}")


class PolarLaunch(NamedTuple):
    """A polarized launch as the kernels take it (``pallas_trace.py::
    _polar_layout`` :1922 and ``_polar_init`` :796-828): ``n_ev`` (1 or 2)
    real E-vectors per ray, each ``a`` s + ``b`` p in the launch basis for
    (a, b) in ``coefs``, and the final intensity ``scale`` x the sum of
    their squared norms. A linear state is one vector; a complex one its
    real and imaginary projections; the unpolarized average the two linear
    states at scale 0.5. Static per call: no gradient flows to it."""
    n_ev: int
    scale: float
    coefs: tuple

    def words(self) -> list:
        """[n_ev, scale, a0, b0, a1, b1], the kernels' argument."""
        flat = [v for ab in self.coefs for v in ab]
        return [float(self.n_ev), self.scale] + flat + [0.0] * (4 - len(flat))


def polar_launch(state):
    """The ``PolarLaunch`` of a launch polarization (``model.polarization``):
    None for "ignore" (no chain); any other string, or a state that is not
    polarized, the unpolarized average; a ``PolarizationState``'s real and
    imaginary projections exr + i exi, eyr + i eyi otherwise."""
    if state is None or (isinstance(state, str) and state == "ignore"):
        return None
    if isinstance(state, str) or not state.is_polarized:
        return PolarLaunch(2, 0.5, ((1.0, 0.0), (0.0, 1.0)))
    exr = state.Ex * math.cos(state.phase_x)
    exi = state.Ex * math.sin(state.phase_x)
    eyr = state.Ey * math.cos(state.phase_y)
    eyi = state.Ey * math.sin(state.phase_y)
    if exi == 0.0 and eyi == 0.0:
        return PolarLaunch(1, 1.0, ((exr, eyr),))
    return PolarLaunch(2, 1.0, ((exr, eyr), (exi, eyi)))


def _polar_init(polar, L, M, N, weight):
    """The launch E-vectors (``pallas_trace.py::_polar_init`` :796): the
    basis p = k x (1, 0, 0) / |.| = (0, N, -M) / |.|, s = p x k, each vector
    a s + b p, scaled by sqrt(w) under an apodization ``weight`` w (the
    double where at w = 0, :2039-2050), in the kernel's order
    (``csrc/gen_trace_common.cuh::polar_init``)."""
    pxv, pyv, pzv = torch.zeros_like(L), N, -M
    m2 = pyv * pyv + pzv * pzv
    inv = torch.reciprocal(_sqrt(torch.where(m2 > 0, m2, 1.0)))
    pxv, pyv, pzv = pxv * inv, pyv * inv, pzv * inv
    sxv = pyv * N - pzv * M
    syv = pzv * L - pxv * N
    szv = pxv * M - pyv * L
    evecs = [(a * sxv + b * pxv, a * syv + b * pyv, a * szv + b * pzv)
             for a, b in polar.coefs]
    if weight is not None:
        pos = weight > 0
        sa = torch.where(pos, _sqrt(torch.where(pos, weight, 1.0)), 0.0)
        evecs = [tuple(c * sa for c in v) for v in evecs]
    return evecs


def _fresnel_diag(n1, n2, cos_i, is_refl: bool):
    """A Fresnel coating's real (js, jp, j3) at cos_i
    (``pallas_trace.py::_fresnel_diag`` :773): the root's argument clamped at
    eps, one shared reciprocal, and (js, -jp, -1) on a mirror."""
    n = n2 / n1
    sin2 = 1.0 - cos_i * cos_i
    rad = n * n - sin2
    root = _sqrt(torch.where(rad > _EPS, rad, _EPS))
    n2c = n * n * cos_i
    da = cos_i + root
    db = n2c + root
    inv = torch.reciprocal(da * db)
    if is_refl:
        return (cos_i - root) * db * inv, -((n2c - root) * da * inv), -1.0
    return 2.0 * cos_i * db * inv, 2.0 * n * cos_i * da * inv, 1.0


def _polar_update(evecs, k0, k1, normal, diag, refract_only: bool):
    """One surface's update of the E-vectors (``pallas_trace.py::
    _polar_update`` :686): E' = js (s.E) s + jp (p0.E) p1 + j3 (k0.E) k1
    with s ~ k0 x n (``normal`` the unit normal, or "plane" for n = (0, 0,
    +-1)), p0 = k0 x s, p1 = k1 x s and the fallback s = k0 x (1, 0, 0)
    below |s|^2 = 1e-12 (a double where before the root); ``diag`` the
    Fresnel (js, jp, j3) or None for 1. A bare refracting surface
    (``refract_only``) takes the rotation about u = k0 x k1 instead,
    E' = cos t E + u x E + u (u.E) / (1 + cos t)."""
    L0, M0, N0 = k0
    L1, M1, N1 = k1
    if diag is None and refract_only:
        ux = M0 * N1 - N0 * M1
        uy = N0 * L1 - L0 * N1
        uz = L0 * M1 - M0 * L1
        ct = L0 * L1 + M0 * M1 + N0 * N1
        inv1c = 1.0 / (1.0 + ct)
        out = []
        for ex, ey, ez in evecs:
            ue = (ux * ex + uy * ey + uz * ez) * inv1c
            out.append((ct * ex + (uy * ez - uz * ey) + ux * ue,
                        ct * ey + (uz * ex - ux * ez) + uy * ue,
                        ct * ez + (ux * ey - uy * ex) + uz * ue))
        return out
    if normal == "plane":
        sx, sy, sz = -M0, L0, torch.zeros_like(L0)
        mag2 = L0 * L0 + M0 * M0
    else:
        nx, ny, nz = normal
        sx = M0 * nz - N0 * ny
        sy = N0 * nx - L0 * nz
        sz = L0 * ny - M0 * nx
        mag2 = sx * sx + sy * sy + sz * sz
    fb = mag2 < POL_FALLBACK
    sx = torch.where(fb, 0.0, sx)
    sy = torch.where(fb, N0, sy)
    sz = torch.where(fb, -M0, sz)
    mag2 = torch.where(fb, N0 * N0 + M0 * M0, mag2)
    inv = torch.reciprocal(_sqrt(torch.where(mag2 > 0, mag2, 1.0)))
    sx, sy, sz = sx * inv, sy * inv, sz * inv
    p0x, p0y, p0z = M0 * sz - N0 * sy, N0 * sx - L0 * sz, L0 * sy - M0 * sx
    p1x, p1y, p1z = M1 * sz - N1 * sy, N1 * sx - L1 * sz, L1 * sy - M1 * sx
    out = []
    for ex, ey, ez in evecs:
        ds = sx * ex + sy * ey + sz * ez
        dp = p0x * ex + p0y * ey + p0z * ez
        dk = L0 * ex + M0 * ey + N0 * ez
        if diag is not None:
            ds, dp, dk = diag[0] * ds, diag[1] * dp, diag[2] * dk
        out.append((ds * sx + dp * p1x + dk * L1,
                    ds * sy + dp * p1y + dk * M1,
                    ds * sz + dp * p1z + dk * N1))
    return out


def _polar_intensity(evecs, scale: float):
    """scale x sum |E|^2 (``pallas_trace.py::_polar_intensity`` :830)."""
    total = None
    for ex, ey, ez in evecs:
        sq = ex * ex + ey * ey + ez * ez
        total = sq if total is None else total + sq
    return total * scale


def _eps_guard(v):
    """|v| > eps ? v : (v >= 0 ? eps : -eps), eps in v's dtype."""
    return torch.where(torch.abs(v) > _EPS, v,
                       torch.where(v >= 0, v.new_tensor(_EPS),
                                   v.new_tensor(-_EPS)))


def _asphere_sag_grad(ri, conic, coefs, odd: bool, xx, yy):
    """Even or odd asphere sag and its gradient (s, ds/dx, ds/dy) on the
    curvature-form conic base, in the kernel's operation order
    (``pallas_trace.py::_asphere_sag_grad``): the conic root's argument is
    clamped to eps, and the odd asphere's r to sqrt(1e-24) on the axis."""
    r2 = xx * xx + yy * yy
    arg = 1.0 - (1.0 + conic) * ri * ri * r2
    sq = _sqrt(torch.where(arg > _EPS, arg, _EPS))
    s = r2 * ri / (1.0 + sq)
    inv_sq = torch.reciprocal(sq)
    gx = xx * ri * inv_sq
    gy = yy * ri * inv_sq
    if odd:
        step = _sqrt(torch.clamp(r2, min=1e-24))
        term, gterm = step, torch.reciprocal(step)
    else:
        step = r2
        term, gterm = r2, torch.ones_like(r2)
    for i, ci in enumerate(coefs):
        kk = float(i + 1) if odd else 2.0 * (i + 1)
        s = s + ci * term
        gx = gx + kk * xx * ci * gterm
        gy = gy + kk * yy * ci * gterm
        term = term * step
        gterm = gterm * step
    return s, gx, gy


def _conic_base(ri, conic, xx, yy):
    """The conic base of the freeform sags: (s, ds/dx, ds/dy) in curvature
    form with the root's argument clamped to eps
    (``pallas_trace.py::_conic_base``)."""
    return _asphere_sag_grad(ri, conic, [], False, xx, yy)


def _axis_conic(cv, k, v):
    """A 1-D conic section's sag and slope in curvature form
    (``pallas_trace.py::_axis_conic``)."""
    arg = 1.0 - (1.0 + k) * cv * cv * v * v
    sq = _sqrt(torch.where(arg > _EPS, arg, _EPS))
    return cv * v * v / (1.0 + sq), cv * v / sq


def _cheb_tu(n, w):
    """T_0..T_{n-1}(w) and T'_k = k U_{k-1}(w), by the recurrences."""
    ts, us = [torch.ones_like(w)], [torch.ones_like(w)]
    if n > 1:
        ts.append(w)
    if n > 2:
        us.append(2.0 * w)
    for _ in range(2, n):
        ts.append(2.0 * w * ts[-1] - ts[-2])
    for _ in range(3, n):
        us.append(2.0 * w * us[-1] - us[-2])
    return ts, [torch.zeros_like(w)] + [float(k) * us[k - 1]
                                        for k in range(1, n)]


def _zernike_sag_grad(ri, conic, nr, coefs, basis, xx, yy):
    """conic + sum_j c_j Z_j(rho / nr, phi) and its slopes
    (``pallas_trace.py::_zernike_sag_grad``), with the term structure of
    ``zernike_terms_table``: cos/sin of m phi by the multiple-angle
    recurrence on (x, y) / r, and each radial polynomial summed in
    ascending powers of rho."""
    s, gx, gy = _conic_base(ri, conic, xx, yy)
    if not coefs:
        return s, gx, gy
    terms = zernike_terms_table(basis, len(coefs))
    r = _sqrt(xx * xx + yy * yy)
    r_safe = torch.clamp(r, min=1e-12)
    rho = r / nr
    cost = xx / r_safe
    sint = yy / r_safe
    rp = [torch.ones_like(rho)]
    for _ in range(max(n for n, _, _, _ in terms)):
        rp.append(rp[-1] * rho)
    cs, sn = [torch.ones_like(cost), cost], [torch.zeros_like(sint), sint]
    for _ in range(2, max(abs(m) for _, m, _, _ in terms) + 1):
        cs.append(2.0 * cost * cs[-1] - cs[-2])
        sn.append(2.0 * cost * sn[-1] - sn[-2])
    dz_drho = torch.zeros_like(rho)
    dz_dphi = torch.zeros_like(rho)
    for cj, (n, m, norm, radial) in zip(coefs, terms):
        Rnm = torch.zeros_like(rho)
        dR = torch.zeros_like(rho)
        for p, coef, pcoef in radial:
            Rnm = Rnm + coef * rp[p]
            if p > 0:
                dR = dR + pcoef * rp[p - 1]
        cj = cj * norm
        if m == 0:
            s = s + cj * Rnm
            dz_drho = dz_drho + cj * dR
            continue
        ang, dang = (cs[m], -float(m) * sn[m]) if m > 0 else \
            (sn[-m], float(-m) * cs[-m])
        s = s + cj * Rnm * ang
        dz_drho = dz_drho + cj * dR * ang
        dz_dphi = dz_dphi + cj * Rnm * dang
    inv_rs = torch.reciprocal(r_safe)
    gx = gx + dz_drho * xx * inv_rs / nr - dz_dphi * yy * inv_rs * inv_rs
    gy = gy + dz_drho * yy * inv_rs / nr + dz_dphi * xx * inv_rs * inv_rs
    return s, gx, gy


def _sag_grad(gkind, nu, nv, gextra, c, coefs, xx, yy):
    """The Newton sags' (s, ds/dx, ds/dy) at (xx, yy) in the kernel's
    operation order (``pallas_trace.py::_freeform_sag_grad``), the
    Chebyshev slope without its 1/norm factor (the reference's quirk).
    ``c(j)`` is the surface's constant column j; ``coefs`` its
    coefficients."""
    ri, conic = c(0), c(1)
    if gkind in ("even", "odd"):
        return _asphere_sag_grad(ri, conic, coefs, gkind == "odd", xx, yy)
    if gkind in ("poly", "cheb"):
        s, gx, gy = _conic_base(ri, conic, xx, yy)
        if gkind == "poly":
            xp, yp = [torch.ones_like(xx)], [torch.ones_like(yy)]
            for _ in range(nu - 1):
                xp.append(xp[-1] * xx)
            for _ in range(nv - 1):
                yp.append(yp[-1] * yy)
            dxp = [None] + [float(i) for i in range(1, nu)]
            dyp = [None] + [float(j) for j in range(1, nv)]
        else:
            xp, dxp = _cheb_tu(nu, xx / c(24))
            yp, dyp = _cheb_tu(nv, yy / c(25))
        for i in range(nu):
            for j in range(nv):
                cij = coefs[i * nv + j]
                s = s + cij * xp[i] * yp[j]
                if gkind == "poly":
                    if i > 0:
                        gx = gx + dxp[i] * cij * xp[i - 1] * yp[j]
                    if j > 0:
                        gy = gy + dyp[j] * cij * xp[i] * yp[j - 1]
                    continue
                if i > 0:
                    gx = gx + cij * dxp[i] * yp[j]
                if j > 0:
                    gy = gy + cij * xp[i] * dyp[j]
        return s, gx, gy
    if gkind == "biconic":
        sy, gy = _axis_conic(ri, conic, yy)
        sx, gx = _axis_conic(c(24), c(25), xx)
        return sx + sy, gx, gy
    if gkind in ("toroidal", "toroidal_inf"):
        zy, dzy = _axis_conic(ri, conic, yy)
        y2 = yy * yy
        term, dterm = y2, yy
        for i, ci in enumerate(coefs):
            zy = zy + ci * term
            dzy = dzy + 2.0 * float(i + 1) * ci * dterm
            term = term * y2
            dterm = dterm * y2
        if gkind == "toroidal_inf":
            return zy, torch.zeros_like(xx), dzy
        R = c(24)
        dz = R - zy
        inside = dz * dz - xx * xx
        ok = inside > _EPS
        root = _sqrt(torch.where(ok, inside, _EPS))
        s = R - torch.where(dz >= 0, 1.0, -1.0) * root
        sgn_r = torch.where(R >= 0, 1.0, -1.0)
        inv_root = torch.reciprocal(root)
        return (s, torch.where(ok, sgn_r * xx * inv_root, 0.0),
                torch.where(ok, sgn_r * dz * dzy * inv_root, 0.0))
    if gkind == "zernike":
        return _zernike_sag_grad(ri, conic, c(24), coefs, gextra, xx, yy)
    if gkind == "qbfs":
        return _qbfs_sag_grad(ri, conic, c(24), coefs, xx, yy)
    if gkind == "q2d":
        return _q2d_sag_grad(ri, conic, c(24), coefs, gextra, xx, yy)
    raise ValueError(f"no Newton sag {gkind!r}")


def _forbes_sigma(ri, k, r2, rho):
    """The Forbes sags' sigma^-1 projection factor and its rho derivative
    in curvature form (``pallas_trace.py::_forbes_sigma``)."""
    c2 = ri * ri
    num_arg = 1.0 - k * c2 * r2
    den_arg = 1.0 - (k + 1.0) * c2 * r2
    nf = _sqrt(torch.where(num_arg > 0, num_arg, 1e-12))
    df = _sqrt(torch.where(den_arg > 0, den_arg, 1e-12))
    return nf / df, (c2 * rho) / (nf * df * df * df)


def _qbfs_sag_grad(ri, conic, nr, bs, xx, yy):
    """The Forbes Qbfs sag and slopes on its basis-changed coefficients
    ``bs`` (``pallas_trace.py::_qbfs_sag_grad``): the sag's Clenshaw sum at
    r^2 / nr^2, the slope's at u^2 with u = sqrt(r^2 + 1e-12) / nr."""
    s, gx, gy = _conic_base(ri, conic, xx, yy)
    if not bs:
        return s, gx, gy
    r2 = xx * xx + yy * yy
    rho = _sqrt(r2 + 1e-12)
    u = rho / nr
    usq_s = r2 / (nr * nr)
    usq = u * u
    poly_s, _ = qbfs_sum(bs, usq_s)
    factor, dfac = _forbes_sigma(ri, conic, r2, rho)
    dep = usq_s * (1.0 - usq_s) * factor * poly_s
    s = s + torch.where(usq_s > 1, 0.0, dep)
    poly_g, dpoly = qbfs_sum(bs, usq)
    ds_du = dpoly * 2.0 * u
    dpref = (2.0 * u - 4.0 * u * usq) / nr
    dpoly_drho = ds_du / nr
    dS = (dpref * factor * poly_g + (usq - usq * usq) * dfac * poly_g
          + (usq - usq * usq) * factor * dpoly_drho)
    dS = torch.where(u >= 1, 0.0, dS)
    inv_rho = 1.0 / rho
    return s, gx + dS * xx * inv_rho, gy + dS * yy * inv_rho


def _q2d_sag_grad(ri, conic, nr, coefs, terms, xx, yy):
    """The Forbes Q2D sag and slopes on its basis-changed coefficient groups
    (``pallas_trace.py::_q2d_sag_grad``): the rotational group by the Qbfs
    sum, each (m, cos/sin) group by the Pnm Clenshaw sums, cos and sin of
    m theta by the multiple-angle recurrence from (x, y) / r."""
    n_m0, len_a, len_b = q2d_layout(terms)
    max_m = len(len_a) - 1
    s, bx, by = _conic_base(ri, conic, xx, yy)
    r2 = xx * xx + yy * yy
    rho = _sqrt(r2 + 1e-12)
    u = rho / nr
    usq = u * u
    # cos and sin of theta; at the vertex theta = 0, as the geometry's
    # arctan2(0, 0) (the JAX kernel's centre tweak compares the padded rho,
    # never below 1e-12, and divides 0 by 0 there)
    s2 = xx * xx + yy * yy
    ok = s2 > 0
    rho2 = _sqrt(torch.where(ok, s2, 1.0))
    cost = torch.where(ok, xx / rho2, 1.0)
    sint = torch.where(ok, yy / rho2, 0.0)
    cs, sn = [torch.ones_like(cost), cost], [torch.zeros_like(sint), sint]
    for _ in range(2, max_m + 1):
        cs.append(2.0 * cost * cs[-1] - cs[-2])
        sn.append(2.0 * cost * sn[-1] - sn[-2])
    zero = torch.zeros_like(u)
    if n_m0:
        s_m0, ds_dusq = qbfs_sum(coefs[:n_m0], usq)
        d_m0_du = ds_dusq * 2.0 * u
    else:
        s_m0, d_m0_du = zero, zero
    off = n_m0
    up = [torch.ones_like(u)]
    for _ in range(max_m):
        up.append(up[-1] * u)
    poly, dr, dt = zero, zero, zero
    for m in range(1, max_m + 1):
        sv = {True: (zero, zero), False: (zero, zero)}
        for ln, is_a in ((len_a[m], True), (len_b[m], False)):
            if not ln:
                continue
            ds = coefs[off:off + ln]
            off += ln
            al0 = clenshaw_q2d(ds, m, usq)
            al1 = clenshaw_q2d_der(ds, m, usq, al0)
            sv[is_a] = (q2d_sum(al0, m, ln), q2d_sum(al1, m, ln))
        (s_a, sp_a), (s_b, sp_b) = sv[True], sv[False]
        poly = poly + up[m] * (cs[m] * s_a + sn[m] * s_b)
        aterm = cs[m] * (2.0 * usq * sp_a + m * s_a)
        bterm = sn[m] * (2.0 * usq * sp_b + m * s_b)
        dr = dr + up[m - 1] * (aterm + bterm)
        dt = dt + m * up[m] * (-s_a * sn[m] + s_b * cs[m])
    factor, dfac = _forbes_sigma(ri, conic, r2, rho)
    dep = usq * (1.0 - usq) * factor * s_m0 + factor * poly
    s = s + torch.where(u > 1, 0.0, dep)
    dpref = (2.0 * u - 4.0 * u * usq) / nr
    dpoly_drho = d_m0_du / nr
    dS0 = (dpref * factor * s_m0 + (usq - usq * usq) * dfac * s_m0
           + (usq - usq * usq) * factor * dpoly_drho)
    dSg = dfac * poly + factor * dr / nr
    dS_drho = torch.where(u >= 1, 0.0, dS0 + dSg)
    dS_dth = torch.where(u >= 1, 0.0, factor * dt)
    inv_rho = 1.0 / rho
    gx = bx + dS_drho * xx * inv_rho - dS_dth * yy * inv_rho * inv_rho
    gy = by + dS_drho * yy * inv_rho + dS_dth * xx * inv_rho * inv_rho
    return s, gx, gy


def _designed_slope(c, x, y):
    """The designed Fresnel facet's slopes (dfdx, dfdy): m (x, y) / r with
    m = -(r / hyp) / (n_design - f / hyp), hyp = sqrt(r^2 + f^2)
    (``pallas_trace.py:1672-1688``)."""
    r2 = x * x + y * y
    r = _sqrt(r2)
    r_safe = torch.clamp(r, min=1e-12)
    f_len = c(24)
    hyp = _sqrt(r2 + f_len * f_len)
    mslope = -(r / hyp) / (c(25) - f_len / hyp)
    return mslope * x / r_safe, mslope * y / r_safe


def _newton(t, x, y, z, L, M, N, sag):
    """A Newton sag's intersection from the conic warm start ``t``: exactly
    ``NEWTON_ITERS`` steps without gradient, then one differentiable step,
    whose gradient is the implicit-function-theorem one (-f_theta / f_t).
    ``sag(xx, yy)`` gives (s, ds/dx, ds/dy)."""
    with torch.no_grad():
        t_it = t.detach()
        xs, ys, zs, Ls, Ms, Ns = (v.detach() for v in (x, y, z, L, M, N))
        for _ in range(NEWTON_ITERS):
            s, gx, gy = sag(xs + t_it * Ls, ys + t_it * Ms)
            f = s - (zs + t_it * Ns)
            t_it = t_it - f / _eps_guard(gx * Ls + gy * Ms - Ns)
    s, gx, gy = sag(x + t_it * L, y + t_it * M)
    f = s - (z + t_it * N)
    return t_it - f / _eps_guard(gx * L + gy * M - N)


def _kahan(opd, opd_c, v):
    """The compensated update of (opd, opd_c) by v, as three separate
    roundings (``pallas_trace.py:1466-1469``)."""
    yk = v - opd_c
    tk = opd + yk
    return tk, (tk - opd) - yk


def _doe_plain(inter, is_plane, is_refl, c, coefs, x, y, L, M, N, inten,
               opd, opd_c, valid, opd_mode):
    """Sub-slice (f) at the landed point (x, y), in the kernels' operation
    order (``csrc/gen_trace_common.cuh::doe_forward``;
    ``pallas_trace.py:1527-1662``): the conic or plane slope and unit
    normal, then the linear grating's diffraction or the phase profile's
    update. Returns (L, M, N, intensity, opd, opd_c, valid)."""
    ri, conic, n1, n2 = c(0), c(1), c(3), c(4)
    zero = torch.zeros_like(x)
    if is_plane:
        dfdx = dfdy = nx = ny = zero
        nz = -torch.ones_like(x)
    else:
        r2 = x * x + y * y
        arg = 1.0 - (1.0 + conic) * ri * ri * r2
        inv_root = torch.reciprocal(_sqrt(torch.where(arg > _EPS, arg, 1.0)))
        dfdx = x * ri * inv_root
        dfdy = y * ri * inv_root
        inv_n = torch.reciprocal(_sqrt(dfdx * dfdx + dfdy * dfdy + 1.0))
        nx, ny, nz = dfdx * inv_n, dfdy * inv_n, -inv_n
    if inter[0] == "grating":
        # the groove tangent t = normalize(1, tan a, dfdx + tan a dfdy),
        # the grating vector f = -normalize(n x t), the strength c24 =
        # m lambda / period scaled by f's xy projection
        ta = c(25)
        tz = dfdx + ta * dfdy
        tinv = torch.reciprocal(_sqrt(1.0 + ta * ta + tz * tz))
        tx, ty, tz = tinv, ta * tinv, tz * tinv
        fx = ny * tz - nz * ty
        fy = nz * tx - nx * tz
        fz = nx * ty - ny * tx
        finv = torch.reciprocal(_sqrt(fx * fx + fy * fy + fz * fz))
        fx, fy, fz = -fx * finv, -fy * finv, -fz * finv
        g = c(24) * _sqrt(fx * fx + fy * fy)
        # the normal aligned along the ray (sign(0) := +1)
        flip = (L * nx + M * ny + N * nz) >= 0
        nxa, nya, nza = (torch.where(flip, v, -v) for v in (nx, ny, nz))
        kx, ky, kz = n1 * L, n1 * M, n1 * N
        kdn = kx * nxa + ky * nya + kz * nza
        tx2 = kx - kdn * nxa + g * fx
        ty2 = ky - kdn * nya + g * fy
        tz2 = kz - kdn * nza + g * fz
        disc = n2 * n2 - (tx2 * tx2 + ty2 * ty2 + tz2 * tz2)
        ok = disc >= 0
        kn = _sqrt(torch.where(ok, disc, 1.0))
        den = n2
        if is_refl:
            kn, den = -kn, -n2
        Lo = (tx2 + kn * nxa) / den
        Mo = (ty2 + kn * nya) / den
        No = (tz2 + kn * nza) / den
        oinv = torch.reciprocal(_sqrt(Lo * Lo + Mo * Mo + No * No))
        return (Lo * oinv, Mo * oinv, No * oinv, inten, opd, opd_c,
                valid & ok)
    _, pkind, plane_cls = inter
    if plane_cls:               # the Plane class's +z normal
        nx, ny, nz = zero, zero, torch.ones_like(x)
    if pkind == "constant":
        phase = c(24).expand_as(x)
        pgx = pgy = zero
    elif pkind == "radial":
        r2p = x * x + y * y
        rp = _sqrt(r2p)
        phase, d_dr, term, rpow = zero, zero, r2p, rp
        for i, ci in enumerate(coefs):
            phase = phase + ci * term
            d_dr = d_dr + ci * (2.0 * (i + 1.0)) * rpow
            term = term * r2p
            rpow = rpow * r2p
        ratio = d_dr / torch.where(rp == 0, 1.0, rp)
        pgx, pgy = ratio * x, ratio * y
    else:                       # the linear grating (Kx, Ky) = c24, c25
        phase = c(24) * x + c(25) * y
        pgx, pgy = c(24).expand_as(x), c(25).expand_as(x)
    # the surface-projected gradient G = pg - (pg . n) n
    gdn = pgx * nx + pgy * ny
    Gx, Gy, Gz = pgx - gdn * nx, pgy - gdn * ny, -gdn * nz
    k0 = _TWO_PI_F / c(7)
    kix, kiy, kiz = n1 * k0 * L, n1 * k0 * M, n1 * k0 * N
    kdn = kix * nx + kiy * ny + kiz * nz
    kpx = kix - kdn * nx + Gx
    kpy = kiy - kdn * ny + Gy
    kpz = kiz - kdn * nz + Gz
    nk = n2 * k0
    rsq = nk * nk - (kpx * kpx + kpy * kpy + kpz * kpz)
    evan = rsq < 0
    # an evanescent order: intensity 0, the ray kept; the double where
    # keeps the root's cotangent finite
    inten = inten * (~evan).to(inten.dtype)
    alpha = _sqrt(torch.where(evan, 1.0, torch.clamp(rsq, min=0.0)))
    alpha = torch.where(evan, 0.0, alpha)
    if is_refl:
        alpha = -alpha
    kox, koy, koz = kpx + alpha * nx, kpy + alpha * ny, kpz + alpha * nz
    minv = torch.reciprocal(_sqrt(kox * kox + koy * koy + koz * koz))
    # OPD -= phase / k0 (um against mm: the reference's quirk, kept)
    shift = -phase / k0
    if opd_mode == "kahan":
        opd, opd_c = _kahan(opd, opd_c, shift)
    else:
        opd = opd + shift
    inten = inten * c(EFF_COL).detach()
    return kox * minv, koy * minv, koz * minv, inten, opd, opd_c, valid


def _surface_plain(flag, c, coefs, state, sigma: float, opd_mode: str):
    """One surface of the plain K1 and K3 (``csrc/gen_trace_common.cuh::
    surface_step``) in the kernels' operation order: ``flag`` is the
    surface's ``SurfaceFlags``, ``c(j)`` its constant column j, ``coefs`` its
    sag coefficients, ``state`` (x, y, z, L, M, N, intensity, opd, opd_c,
    valid) the rays before it, followed under a polarized launch by the
    list of E-vectors, ``sigma`` the static propagation sign (read by the
    split mode only); returns the state after it."""
    (is_plane, is_refl, absorbing, gkind, nu, has_cs, has_ap, coat, nv,
     gextra, inter) = flag
    x, y, z, L, M, N, inten, opd, opd_c, valid, *pol = state
    split = opd_mode == "split"
    ri, conic, pos_z, n1, n2, alpha = (c(j) for j in range(6))
    fresnel = gkind in FRESNEL_KINDS
    newton = gkind != "conic" and not fresnel

    def sag(xx, yy):
        return _sag_grad(gkind, nu, nv, gextra, c, coefs, xx, yy)

    # localize: v_local = R^T (v - t)
    if has_cs:
        r = [c(8 + j) for j in range(9)]
        dx0, dy0, dz0 = x - c(17), y - c(18), z - c(19)
        x = r[0] * dx0 + r[3] * dy0 + r[6] * dz0
        y = r[1] * dx0 + r[4] * dy0 + r[7] * dz0
        z = r[2] * dx0 + r[5] * dy0 + r[8] * dz0
        L, M, N = (r[0] * L + r[3] * M + r[6] * N,
                   r[1] * L + r[4] * M + r[7] * N,
                   r[2] * L + r[5] * M + r[8] * N)
    elif split:
        zp = z
        z = zp - c(27)
    else:
        z = z - pos_z

    if is_plane or fresnel:             # the thin Fresnel base plane
        t = -z / N
    else:
        t0 = -z / N
        x0 = x + t0 * L
        y0 = y + t0 * M
        a = (conic * N * N + 1.0) * ri
        bh = (L * x0 + M * y0) * ri - N
        cc = (x0 * x0 + y0 * y0) * ri
        disc = bh * bh - a * cc
        ok = disc >= 0
        sq = _sqrt(torch.where(ok, disc, 1.0))
        q = -(bh + torch.where(bh >= 0, sq, -sq))   # sign(0) := +1
        t_far = q / _eps_guard(a)
        t_near = cc / _eps_guard(q)
        tq = torch.where(torch.abs(t_near) <= torch.abs(t_far),
                         t_near, t_far)
        tq = torch.where(ok, tq, 0.0)
        t = t0 + tq
        valid = valid & ok
    if newton:
        t = _newton(t, x, y, z, L, M, N, sag)
    x = x + t * L
    y = y + t * M
    z = z + t * N
    if split:
        # the path's deviation from the axial gap, sag-scale:
        # n1 gap (1-|N|)/|N| - n1 zp/|N| + n1 tq, with |N| = sigma N
        nabs = sigma * N
        onem = (L * L + M * M) / (1.0 + nabs)
        dev = (n1 * sigma * c(27)) * (onem / nabs) \
            - (sigma * n1) * zp / nabs
        if not is_plane:
            dev = dev + n1 * tq
        opd, opd_c = _kahan(opd, opd_c, dev)
        # z from the exact sag at the landed (x, y)
        if is_plane:
            z = torch.zeros_like(z)
        else:
            r2 = x * x + y * y
            arg = 1.0 - (1.0 + conic) * ri * ri * r2
            z = r2 * ri / (1.0 + _sqrt(torch.where(arg > _EPS, arg,
                                                        _EPS)))
    elif opd_mode == "kahan":
        opd, opd_c = _kahan(opd, opd_c, torch.abs(t * n1))
    else:
        opd = opd + torch.abs(t * n1)
    if absorbing:
        inten = inten * torch.exp(-alpha * t * 1e3)
    if has_ap:                          # intensity mask, local frame
        xa, ya = x - c(22), y - c(23)
        r2a = xa * xa + ya * ya
        inten = inten * ((r2a >= c(20)) & (r2a <= c(21))).to(inten.dtype)

    conic_like = gkind in ("conic", "fresnel_zone")
    k0 = (L, M, N)              # the local directions before the interaction
    if conic_like and is_plane:
        cos_i, normal = torch.abs(N), "plane"
    if inter is not None:       # sub-slice (f): no chain update, no coating
        L, M, N, inten, opd, opd_c, valid = _doe_plain(
            inter, is_plane, is_refl, c, coefs, x, y, L, M, N, inten, opd,
            opd_c, valid, opd_mode)
    elif conic_like and is_plane and is_refl:
        N = -N
    elif conic_like and is_plane:
        u = n1 / n2
        disc_r = 1.0 - u * u * (1.0 - N * N)
        ok_r = disc_r >= 0
        root_r = _sqrt(torch.where(ok_r, disc_r, 1.0))
        valid = valid & ok_r
        L, M, N = u * L, u * M, torch.sign(N) * root_r
    else:
        if conic_like:                  # a zoned lens: the parent's slope
            r2 = x * x + y * y
            arg = 1.0 - (1.0 + conic) * ri * ri * r2
            inv_root = torch.reciprocal(_sqrt(
                torch.where(arg > _EPS, arg, 1.0)))
            dfdx = x * ri * inv_root
            dfdy = y * ri * inv_root
        elif gkind == "fresnel_designed":
            dfdx, dfdy = _designed_slope(c, x, y)
        else:                           # the Newton sag's own slope
            _, dfdx, dfdy = sag(x, y)
        inv_n = torch.reciprocal(_sqrt(dfdx * dfdx + dfdy * dfdy
                                       + 1.0))
        nx, ny, nz = dfdx * inv_n, dfdy * inv_n, -inv_n
        dot = L * nx + M * ny + N * nz
        cos_i, normal = torch.abs(dot), (nx, ny, nz)
        if is_refl:
            two_dot = 2.0 * dot
            L, M, N = L - two_dot * nx, M - two_dot * ny, N - two_dot * nz
        else:
            u = n1 / n2
            disc_r = 1.0 - u * u * (1.0 - dot * dot)
            ok_r = disc_r >= 0
            root_r = _sqrt(torch.where(ok_r, disc_r, 1.0))
            w = torch.sign(dot) * root_r - u * dot
            L, M, N = u * L + nx * w, u * M + ny * w, u * N + nz * w
            valid = valid & ok_r
    # the polarization chain, on the local directions before and after the
    # interaction, before the scalar coating and the globalize (the
    # E-vectors are not rotated into the global frame, pallas_trace.py:
    # 1517-1519, 1724-1731); a grating or phase step leaves it as it is
    if pol and inter is None:
        diag = _fresnel_diag(c(3), c(4), cos_i, is_refl) \
            if coat == "fresnel" else None
        pol = [_polar_update(pol[0], k0, (L, M, N), normal, diag,
                             refract_only=not is_refl)]
    if coat == "simple":
        inten = inten * c(6)

    # globalize: v = R v_local + t
    if has_cs:
        x, y, z = (r[0] * x + r[1] * y + r[2] * z + c(17),
                   r[3] * x + r[4] * y + r[5] * z + c(18),
                   r[6] * x + r[7] * y + r[8] * z + c(19))
        L, M, N = (r[0] * L + r[1] * M + r[2] * N,
                   r[3] * L + r[4] * M + r[5] * N,
                   r[6] * L + r[7] * M + r[8] * N)
    elif not split:
        z = z + pos_z
    return (x, y, z, L, M, N, inten, opd, opd_c, valid, *pol)


def split_takes(flags) -> bool:
    """Whether the split-OPD mode takes these ``SurfaceFlags``: untilted
    conic and plane surfaces that refract or reflect."""
    return all(f.gkind == "conic" and not f.has_cs and f.inter is None
               for f in (SurfaceFlags(*f) for f in flags))


def xy_takes(flags) -> bool:
    """Whether the coord_split mode of sub-slice (h) takes these
    ``SurfaceFlags``: the split mode's surfaces, with no Fresnel coating."""
    return split_takes(flags) and all(SurfaceFlags(*f).coat != "fresnel"
                                      for f in flags)


def _eps_guard64(v):
    """|v| > eps ? v : (v >= 0 ? eps : -eps), the cotangent to the taken
    branch (``pallas_trace.py:1154-1157``)."""
    eps = torch.full_like(v, _EPS)
    return torch.where(torch.abs(v) > _EPS, v, torch.where(v >= 0, eps, -eps))


def _round32(v):
    """``v`` rounded to float32 (its value in ``v``'s dtype), differentiated
    as the identity in that dtype: a float32 scalar of the kernels, whose
    cotangent they carry in float64. The rounding is the float32 operation's
    when ``v`` is one float64 operation on float32 values (the quotient's,
    exact products' and sums' rounding twice gives the same bits)."""
    return v + (v.float().to(v.dtype) - v).detach()


def _xy_surface(flag, c, state):
    """One surface of the coord_split mode (``pallas_trace.py::
    _surface_step_xy`` and ``_df32_chain``, :1153-1309) in float64, in the
    operation order of ``csrc/gen_trace_xy.cuh::xy_step``: ``c(j)`` is the
    surface's float32 constant column j, ``state`` (x, y, z, L, M, N, opd,
    valid, intensity) with the first seven float64, z local to the previous
    vertex, and the intensity float32. The scalars the JAX chain keeps in
    float32 stay there (``_round32``): u = n1 / n2, -(u u) and -(1 +
    conic). Absorption,
    the aperture and the coating act in float32 on the rounded t and
    position, as the JAX step does."""
    is_plane, is_refl, absorbing = flag.is_plane, flag.is_refl, flag.absorbing
    x, y, z, L, M, N, opd, valid, inten = state
    d = torch.float64
    conic, n1, n2 = c(1).to(d), c(3).to(d), c(4).to(d)
    ci = c(0).to(d) + c(28).to(d)       # the two-float curvature's sum
    z = z - c(27).to(d)
    if is_plane:
        t = -z / N
    else:
        t0 = -z / N
        x0 = x + t0 * L
        y0 = y + t0 * M
        a = (N * N * conic + 1.0) * ci
        bh = (L * x0 + M * y0) * ci - N
        cc = (x0 * x0 + y0 * y0) * ci
        disc = bh * bh - a * cc
        ok = disc >= 0
        sq = torch.sqrt(torch.where(ok, disc, 1.0))
        q = -(bh + torch.where(bh >= 0, sq, -sq))
        qs = _eps_guard64(q)
        t_near = cc / qs
        t_far = qs / _eps_guard64(a)
        tq = torch.where(torch.abs(t_near) <= torch.abs(t_far), t_near, t_far)
        t = t0 + torch.where(ok, tq, 0.0)
        valid = valid & ok
    x = x + t * L
    y = y + t * M
    z = z + t * N
    opd = opd + t * n1

    if is_plane and is_refl:
        N = -N
    elif is_plane or not is_refl:
        u = _round32(n1 / n2)
        nuu = _round32(-(u * u))
    if is_plane and not is_refl:
        disc_r = 1.0 + (1.0 - N * N) * nuu
        ok_r = disc_r >= 0
        root = torch.sqrt(torch.where(ok_r, disc_r, 1.0))
        valid = valid & ok_r
        L, M, N = L * u, M * u, root * torch.where(N >= 0, 1.0, -1.0)
    elif not is_plane:
        r2 = x * x + y * y
        arg = 1.0 + (r2 * (ci * ci)) * _round32(-(1.0 + conic))
        ir = torch.reciprocal(torch.sqrt(torch.where(arg > _EPS, arg, 1.0)))
        dfdx = (x * ir) * ci
        dfdy = (y * ir) * ci
        im = torch.reciprocal(torch.sqrt(dfdx * dfdx + dfdy * dfdy + 1.0))
        nx, ny, nz = dfdx * im, dfdy * im, -im
        dot = L * nx + M * ny + N * nz
        if is_refl:
            td = dot * 2.0
            L, M, N = L - td * nx, M - td * ny, N - td * nz
        else:
            disc_r = 1.0 + (1.0 - dot * dot) * nuu
            ok_r = disc_r >= 0
            root = torch.sqrt(torch.where(ok_r, disc_r, 1.0))
            valid = valid & ok_r
            w = root * torch.where(dot >= 0, 1.0, -1.0) + dot * (-u)
            L, M, N = L * u + nx * w, M * u + ny * w, N * u + nz * w

    if absorbing:
        inten = inten * torch.exp(-c(5) * t.float() * 1e3)
    if flag.has_ap:
        xa, ya = x.float() - c(22), y.float() - c(23)
        r2a = xa * xa + ya * ya
        inten = inten * ((r2a >= c(20)) & (r2a <= c(21))).to(inten.dtype)
    if flag.coat == "simple":
        inten = inten * c(6)
    return x, y, z, L, M, N, opd, valid, inten


def _gen_trace_plain_xy(gen, consts, Px, Py, flags, final_prop: bool):
    """The coord_split mode of ``gen_trace_plain``: (out [8, W, F, n],
    base [W, F]). The chief ray, traced once per (wavelength, field), is
    the pupil-centre sample appended as sample n, so that its OPD is the
    one any exact pupil-centre ray gets and its cotangent flows back
    through its own chain."""
    W, F, n = consts.shape[0], gen.shape[0], Px.shape[0]
    d = torch.float64

    def g(j):                               # per-field constant, [1, F, 1]
        return gen[:, j].reshape(1, F, 1)

    zero = torch.zeros(1, dtype=Px.dtype, device=Px.device)
    px = torch.cat([Px, zero]).reshape(1, 1, n + 1).to(d)
    py = torch.cat([Py, zero]).reshape(1, 1, n + 1).to(d)
    telecentric, code = launch_mode(gen)
    x = (px * g(0).to(d) + g(2).to(d)).expand(W, F, n + 1)
    y = (py * g(1).to(d) + g(3).to(d)).expand(W, F, n + 1)
    if telecentric:
        dxr = (px * g(8).to(d)).expand(W, F, n + 1)
        dyr = (py * g(9).to(d)).expand(W, F, n + 1)
        dzr = g(5).to(d).expand(W, F, n + 1)
    else:
        dxr = px * g(8).to(d) - x
        dyr = py * g(9).to(d) - y
        # the aim's axial distance, taken in float32 as the JAX launch
        # takes it (pallas_trace.py:1993-1994)
        dzr = (g(5) - g(4)).to(d).expand(W, F, n + 1)
    im = torch.reciprocal(torch.sqrt(dxr * dxr + dyr * dyr + dzr * dzr))
    L, M, N = dxr * im, dyr * im, dzr * im
    weight = apod_weight(code, lambda j: g(12 + j).detach(),
                         Px.reshape(1, 1, n), Py.reshape(1, 1, n))
    inten = torch.ones((W, F, n), dtype=Px.dtype, device=Px.device) \
        if weight is None else weight.expand(W, F, n)
    inten = torch.cat([inten, torch.ones_like(inten[..., :1])], dim=-1)
    z = torch.zeros_like(x)
    opd = torch.zeros_like(x)
    valid = torch.ones_like(x, dtype=torch.bool)
    state = (x, y, z, L, M, N, opd, valid, inten)
    for k, flag in enumerate(flags):
        def c(j, k=k):                  # per-wavelength constant, [W, 1, 1]
            return consts[:, k, j].reshape(W, 1, 1)
        state = _xy_surface(SurfaceFlags(*flag), c, state)
    x, y, z, L, M, N, opd, valid, inten = state
    if final_prop:
        t_img = g(6).to(d)
        x = x + L * t_img
        y = y + M * t_img
        z = z + N * t_img
    dev = opd[..., :n] - opd[..., n:]
    valid = valid[..., :n]

    def m(v):
        return torch.where(valid, v[..., :n].float(), torch.nan)
    out = torch.stack([m(x), m(y), m(z), m(L), m(M), m(N), inten[..., :n],
                       m(dev)])
    return out, opd[..., n].float()


def gen_trace_plain(gen, consts, acoef, Px, Py, flags, final_prop: bool,
                    opd_mode: str = "plain", polar=None):
    """Plain PyTorch K1 on the packed tables: every elementwise operation of
    ``csrc/gen_trace.cu`` in the same order, broadcast over [W, F, n].
    ``flags`` are ``model_flags``'; ``acoef`` [S, C] holds the sag
    coefficients; ``opd_mode`` is one of ``OPD_MODES``. Differentiable by autograd
    (the Newton search is not taped).

    In the "split" mode z is local to the last vertex (also in the output),
    column 27 holds each surface's vertex gap (surface 1's from the launch
    plane), and the OPD output is the deviation from the axial base.
    ``polar``: a ``PolarLaunch`` (sub-slice (e)), or None unpolarized.

    The "xy" mode (sub-slice (h), coord_split) carries the ray state in
    float64 (``_xy_surface``), with the split mode's local z and column 27,
    and column 28 the low word of the curvature; it returns (out, base):
    the OPD output is the deviation from the chief ray's (the pupil-centre
    ray of each wavelength and field), base [W, F] the chief's own OPD."""
    W, S = consts.shape[0], consts.shape[1]
    F, n = gen.shape[0], Px.shape[0]
    if len(flags) != S:
        raise ValueError(f"{len(flags)} flags for {S} surfaces")
    if opd_mode not in OPD_MODES:
        raise ValueError(f"unknown OPD mode {opd_mode!r}")
    if opd_mode == "xy":
        if not xy_takes(flags) or polar is not None:
            raise ValueError("the coord_split mode takes unpolarized "
                             "untilted conic/plane surfaces that refract or "
                             "reflect, without a Fresnel coating, only")
        return _gen_trace_plain_xy(gen, consts, Px, Py, flags, final_prop)
    split = opd_mode == "split"
    if split and not split_takes(flags):
        raise ValueError("the split-OPD mode takes untilted conic/plane "
                         "surfaces that refract or reflect only")

    def g(j):                               # per-field constant, [1, F, 1]
        return gen[:, j].reshape(1, F, 1)

    px = Px.reshape(1, 1, n)
    py = Py.reshape(1, 1, n)
    telecentric, code = launch_mode(gen)
    x = (px * g(0) + g(2)).expand(W, F, n)
    y = (py * g(1) + g(3)).expand(W, F, n)
    z = g(4).expand(W, F, n)
    if telecentric:             # x1 = Px*B + x0 at the axial distance g5
        dxr = (px * g(8)).expand(W, F, n)
        dyr = (py * g(9)).expand(W, F, n)
        dzr = g(5).expand(W, F, n)
    else:
        dxr = px * g(8) - x
        dyr = py * g(9) - y
        dzr = g(5) - z
    inv_mag = torch.reciprocal(_sqrt(dxr * dxr + dyr * dyr + dzr * dzr))
    L, M, N = dxr * inv_mag, dyr * inv_mag, dzr * inv_mag
    weight = apod_weight(code, lambda j: g(12 + j).detach(), px, py)
    inten = torch.ones_like(x) if weight is None else \
        weight.expand(W, F, n).clone()
    opd = torch.zeros_like(x)
    opd_c = torch.zeros_like(x)
    valid = torch.ones_like(x, dtype=torch.bool)
    if split:                   # z local to the launch plane from here on
        z = torch.zeros_like(x)
    sigma = 1.0                 # the static propagation sign

    state = (x, y, z, L, M, N, inten, opd, opd_c, valid)
    if polar is not None:
        state += (_polar_init(polar, L, M, N, weight),)
    for k, flag in enumerate(flags):
        flag = SurfaceFlags(*flag)

        def c(j, k=k):                      # per-wavelength constant, [W, 1, 1]
            return consts[:, k, j].reshape(W, 1, 1)
        coefs = [acoef[k, i] for i in range(n_coefs(flag.gkind, flag.nu,
                                                    flag.nv))]
        state = _surface_plain(flag, c, coefs, state, sigma, opd_mode)
        if flag.is_refl:
            sigma = -sigma
    x, y, z, L, M, N, inten, opd, opd_c, valid, *pol = state
    if pol:     # the chain's intensity replaces the traced one
        inten = _polar_intensity(pol[0], polar.scale)

    if final_prop:
        t_img = g(6)
        x = x + t_img * L
        y = y + t_img * M
        z = z + t_img * N

    def m(v):
        return torch.where(valid, v, torch.nan)
    return torch.stack([m(x), m(y), m(z), m(L), m(M), m(N), inten, m(opd)])


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(str(Path(os.environ[env]) / "bin" / "nvcc"))
    candidates.append(_DEFAULT_NVCC)
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found: the CUDA kernels (kernels/csrc/*.cu) are built "
        "from source at first use. Install the CUDA toolkit, or put nvcc on "
        "PATH or under CUDA_HOME/bin.")


# each library's C entry points: (name, argument types, result type). K1's
# polarized instances (sub-slice (e)) are a library of their own,
# csrc/gen_trace_pol.cu, with the same entry point
_SIGNATURES = {
    lib: [("gen_trace_launch", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
              ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
              ctypes.POINTER(ctypes.c_int)], ctypes.c_int)]
    for lib in ("gen_trace", "gen_trace_pol")}
# K3 (csrc/trace.cu, kernels/trace_conic.py) and K4 (csrc/huygens.cu,
# kernels/huygens.py)
_SIGNATURES["trace"] = [
    ("trace_launch", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
     + [ctypes.c_longlong, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)],
     ctypes.c_int)]
_SIGNATURES["huygens"] = [
    ("huygens_occupancy", [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2,
     ctypes.c_int),
    ("huygens_launch", [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    ("huygens_root_check", [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                            ctypes.c_void_p], ctypes.c_int)]
# K2: one library per OPD mode (csrc/gen_grad.cu, gen_grad_kahan.cu,
# gen_grad_split.cu), per launch (the polarized instances in
# gen_grad_pol.cu, gen_grad_pol_kahan.cu, gen_grad_pol_split.cu) and for
# the systems with a grating or phase surface (sub-slice (f), the plain and
# Kahan modes: gen_grad_doe.cu, gen_grad_doe_kahan.cu, gen_grad_pol_doe.cu,
# gen_grad_pol_doe_kahan.cu), one signature
GRAD_LIBS = {"plain": "gen_grad", "kahan": "gen_grad_kahan",
             "split": "gen_grad_split"}
GRAD_POL_LIBS = {"plain": "gen_grad_pol", "kahan": "gen_grad_pol_kahan",
                 "split": "gen_grad_pol_split"}
GRAD_DOE_LIBS = {"plain": "gen_grad_doe", "kahan": "gen_grad_doe_kahan"}
GRAD_POL_DOE_LIBS = {"plain": "gen_grad_pol_doe",
                     "kahan": "gen_grad_pol_doe_kahan"}
# sub-slice (h), the coord_split mode: K1 and K2 in float64, libraries of
# their own (csrc/gen_trace_xy.cu, csrc/gen_grad_xy.cu)
_SIGNATURES["gen_trace_xy"] = [
    ("gen_trace_xy_launch", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)]
_SIGNATURES["gen_grad_xy"] = [
    ("gen_grad_xy_partials_size", [ctypes.c_int] * 3 + [ctypes.c_longlong],
     ctypes.c_longlong),
    ("gen_grad_xy_launch", [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)]
for _lib in (list(GRAD_LIBS.values()) + list(GRAD_POL_LIBS.values())
             + list(GRAD_DOE_LIBS.values())
             + list(GRAD_POL_DOE_LIBS.values())):
    _SIGNATURES[_lib] = [
        ("gen_grad_partials_size", [ctypes.c_void_p] + [ctypes.c_int] * 3
         + [ctypes.c_longlong, ctypes.c_int], ctypes.c_longlong),
        ("gen_grad_launch", [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int)], ctypes.c_int)]


def has_doe(flags) -> bool:
    """Whether any of the ``SurfaceFlags`` is a grating or phase surface."""
    return any(SurfaceFlags(*f).inter is not None for f in flags)


def grad_lib(opd_mode: str, polar, doe: bool) -> str:
    """The K2 library of an OPD mode, a launch polarization (a
    ``PolarLaunch`` or None) and a system with (``doe``) or without a
    grating or phase surface."""
    libs = ((GRAD_POL_DOE_LIBS if doe else GRAD_POL_LIBS) if polar
            else (GRAD_DOE_LIBS if doe else GRAD_LIBS))
    return libs[opd_mode]


def polar_words(polar):
    """The kernels' polarization argument: a float[6] of
    ``PolarLaunch.words`` or None (unpolarized)."""
    return None if polar is None else (ctypes.c_float * 6)(*polar.words())

# what ptxas said about each library built in this process (-Xptxas -v:
# registers, spills, shared memory per kernel)
BUILD_LOG: dict = {}


def _sources_key() -> str:
    """Hash of every file under csrc/ (a header change rebuilds them all)."""
    h = hashlib.sha256()
    for path in sorted(_CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build_kernel(name: str):
    """Compile ``csrc/<name>.cu`` for sm_90a into a shared library under
    ``kernels/_build/`` (keyed by a hash of every source), load it with
    ctypes and declare its signatures."""
    src = _CSRC / f"{name}.cu"
    lib_path = _BUILD_DIR / f"{name}_{_sources_key()}.so"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler",
               "-fPIC", "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        BUILD_LOG[name] = res.stderr
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for fn_name, argtypes, restype in _SIGNATURES[name]:
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build_kernels() -> dict:
    """Build every library at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(_SIGNATURES)) as pool:
        return dict(zip(_SIGNATURES, pool.map(build_kernel, _SIGNATURES)))


def check_tables(gen, consts, acoef, Px, Py, flags, opd_mode="plain",
                 **more):
    """Raise ValueError unless the kernels take these inputs: contiguous
    float32 CUDA tensors on one device (``more`` names further ones), gen
    [F, 16], consts [W, S, 32], acoef [S, C] with C at least every surface's
    asphere terms, Px/Py [n], one ``SurfaceFlags`` per surface, an OPD mode of
    ``OPD_MODES`` (the split mode for untilted conic/plane surfaces only,
    the "xy" mode for those without a Fresnel coating). Returns (W, S, F,
    n, C), the flag words and the mode's code."""
    if opd_mode not in OPD_MODES:
        raise ValueError(f"unknown OPD mode {opd_mode!r}")
    if opd_mode == "split" and not split_takes(flags):
        raise ValueError("the split-OPD mode takes untilted conic/plane "
                         "surfaces that refract or reflect only")
    if opd_mode == "xy" and not xy_takes(flags):
        raise ValueError("the coord_split mode takes untilted conic/plane "
                         "surfaces that refract or reflect, without a "
                         "Fresnel coating, only")
    dev = Px.device
    for name, t in (("gen", gen), ("consts", consts), ("acoef", acoef),
                    ("Px", Px), ("Py", Py), *more.items()):
        if not isinstance(t, torch.Tensor) or t.device != dev \
                or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    W, S = consts.shape[0], consts.shape[1]
    F, n = gen.shape[0], Px.shape[0]
    if (consts.shape[2] != CONST_W or gen.shape[1] != GEN_W
            or Px.shape != Py.shape or Px.ndim != 1 or acoef.ndim != 2
            or acoef.shape[0] != S):
        raise ValueError("bad table shapes: gen [F, 16], consts [W, S, 32], "
                         "acoef [S, C], Px/Py [n]")
    if len(flags) != S or not 1 <= S <= MAX_SURFACES:
        raise ValueError(f"need 1..{MAX_SURFACES} surfaces with one flag "
                         f"each, got {S} surfaces and {len(flags)} flags")
    if any(acoef_width(f.gkind, f.nu, f.nv) > acoef.shape[1]
           for f in flags):
        raise ValueError("acoef has fewer columns than a surface's terms")
    if not (1 <= F <= 65535 and 1 <= W <= 65535):
        raise ValueError("F and W must be in 1..65535")
    return ((W, S, F, n, acoef.shape[1]), _flag_words(flags),
            OPD_MODES.index(opd_mode))


def gen_trace_cuda(gen, consts, acoef, Px, Py, flags, final_prop: bool,
                   opd_mode: str = "plain", polar=None):
    """Launch the CUDA K1 on the current stream; returns [8, W, F, n]
    float32 (in the "xy" mode, ``gen_trace_xy_cuda``'s (out, base)).
    ``polar``: a ``PolarLaunch``, which the polarized library
    (``csrc/gen_trace_pol.cu``) takes. Raises on anything the kernel does
    not take."""
    if opd_mode == "xy":
        if polar is not None:
            raise ValueError("the coord_split mode takes no polarized launch")
        return gen_trace_xy_cuda(gen, consts, acoef, Px, Py, flags,
                                 final_prop)
    (W, S, F, n, C), words, mode = check_tables(gen, consts, acoef, Px, Py,
                                                flags, opd_mode)
    dev = Px.device
    out = torch.empty((8, W, F, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = build_kernel("gen_trace" if polar is None else "gen_trace_pol")
    words = (ctypes.c_int32 * S)(*words)
    stream = torch.cuda.current_stream(dev).cuda_stream
    variant = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        err = lib.gen_trace_launch(gen.data_ptr(), consts.data_ptr(),
                                   acoef.data_ptr(),
                                   zernike_table(dev).data_ptr(),
                                   Px.data_ptr(),
                                   Py.data_ptr(), out.data_ptr(),
                                   ctypes.addressof(words), S, F, W, C, n,
                                   int(bool(final_prop)), mode,
                                   polar_words(polar), stream,
                                   ctypes.byref(variant))
    if err != 0:
        raise RuntimeError(f"gen_trace kernel launch failed: CUDA error {err}")
    gen_trace_cuda.launches += 1
    gen_trace_cuda.launches_by_mode[opd_mode] += 1
    gen_trace_cuda.launches_by_variant[VARIANTS[variant.value]] += 1
    gen_trace_cuda.launches_polarized += polar is not None
    gen_trace_cuda.launches_doe += has_doe(flags)
    return out


gen_trace_cuda.launches = 0
gen_trace_cuda.launches_by_mode = dict.fromkeys(OPD_MODES, 0)
gen_trace_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
gen_trace_cuda.launches_polarized = 0
gen_trace_cuda.launches_doe = 0


def gen_trace_xy_cuda(gen, consts, acoef, Px, Py, flags, final_prop: bool):
    """K1 in the coord_split mode of sub-slice (h) (``csrc/gen_trace_xy.cu``,
    float64 ray state): (out [8, W, F, n] float32, base [W, F] float32, the
    chief ray's OPD); ``acoef`` is checked and not read (the mode has no
    sag coefficients). One call is one launch of K1 (h), counted on
    ``gen_trace_cuda``: the C entry runs the chief kernel, then the ray
    kernel, on the current stream."""
    (W, S, F, n, _), words, _ = check_tables(gen, consts, acoef, Px, Py,
                                             flags, "xy")
    if n < 1:
        raise ValueError("the coord_split mode needs at least one ray")
    dev = Px.device
    out = torch.empty((8, W, F, n), dtype=torch.float32, device=dev)
    base = torch.empty((W, F), dtype=torch.float32, device=dev)
    chief = torch.empty((W, F), dtype=torch.float64, device=dev)
    lib = build_kernel("gen_trace_xy")
    words = (ctypes.c_int32 * S)(*words)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.gen_trace_xy_launch(
            gen.data_ptr(), consts.data_ptr(), Px.data_ptr(), Py.data_ptr(),
            out.data_ptr(), base.data_ptr(), chief.data_ptr(),
            ctypes.addressof(words), S, F, W, n, int(bool(final_prop)),
            stream)
    if err != 0:
        raise RuntimeError(f"gen_trace_xy kernel launch failed: CUDA error "
                           f"{err}")
    gen_trace_cuda.launches += 1
    gen_trace_cuda.launches_by_mode["xy"] += 1
    return out, base


def gen_trace_conic(model: OpticModel, params, Px, Py, wavelength,
                    Hx=0.0, Hy=0.0, final_prop: bool = False,
                    kahan: bool = False, opd_split: bool = False,
                    keep_local_z: bool = False, apodization=None,
                    coord_split: bool = False):
    """Fused generation + trace of the pupil samples (Px, Py) for the
    wavelength(s) and field point(s) given; the counterpart of
    ``pallas_gen_trace_conic``.

    K1 runs on the device of ``Px``: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors, with no fallback between the two.

    Gradients: when the tables or the pupil samples require grad, the call
    goes through ``gen_grad.GenTrace``, whose backward is K2 on the same
    device (the CUDA kernel, or on CPU tensors its plain version); the
    cotangents then flow on through the packing into the parameters by
    ordinary autograd.

    ``kahan``: the compensated OPD sum. ``opd_split`` (requires
    ``supports_split_opd``): the split-OPD mode; the call returns ``(rays,
    base)``, with ``rays.opd`` the deviation from the axial base ``base``
    (per wavelength: a scalar for a scalar wavelength, else [W]; the total
    OPD is base + deviation), computed here from the constants so that it
    is differentiable. Its z is global unless ``keep_local_z``, which keeps
    it local to the image vertex. ``apodization``: one of the closed-form
    profiles of ``system/apodization.py``, evaluated by the kernel on the
    launch intensity. The model's launch polarization (``polar_launch``)
    goes to the kernel as it is; a polarized launch's intensity is the
    chain's, with the apodization's weight (the JAX kernel's; the eager
    trace of a polarized state leaves the weight out).

    ``coord_split`` (requires ``supports_split_xy``; sub-slice (h)): the
    whole ray state in float64 against a chief ray per wavelength and field
    (K1 (h)); it takes precedence over ``kahan`` and ``opd_split``. The
    call returns ``(rays, base)`` with ``rays.opd`` the deviation from the
    chief's OPD and ``base`` the chief's own (a scalar, [F], [W] or [W, F]
    as the wavelength and field are scalars or vectors), differentiable;
    z as in the split mode.

    A scalar wavelength and scalar field return ``n`` rays; a field vector
    F*n rays (field-major); a wavelength vector W*F*n rays in (wavelength,
    field, pupil) order. Outputs are float32."""
    if not (supports_model(model) and gen_eligible(model)):
        raise ValueError("system/call not eligible for the K1 kernel")
    if coord_split and not supports_split_xy(model):
        raise ValueError("coord_split needs an untilted, unpolarized "
                         "conic/plane stack with simple or no coatings")
    if opd_split and not supports_split_opd(model):
        raise ValueError("opd_split needs an untilted conic/plane stack")
    px = torch.as_tensor(Px, dtype=torch.float32).contiguous()
    py = torch.as_tensor(Py, dtype=torch.float32).contiguous()
    if px.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K1 has no version for device {px.device}")
    flags = model_flags(model, params)
    gen, consts, acoef = gen_tables(model, params, wavelength, Hx, Hy,
                                    apodization)
    mode = "xy" if coord_split else (
        "split" if opd_split else ("kahan" if kahan else "plain"))
    polar = polar_launch(model.polarization)
    if opd_split or coord_split:
        consts = split_consts(params, gen, consts)
    if any(t.requires_grad for t in (gen, consts, acoef, px, py)):
        from .gen_grad import GenTrace
        out = GenTrace.apply(gen, consts, acoef, px, py, flags, final_prop,
                             mode, polar)
    elif px.device.type == "cpu":
        out = gen_trace_plain(gen, consts, acoef, px, py, flags, final_prop,
                              mode, polar)
    else:
        out = gen_trace_cuda(gen, consts, acoef, px, py, flags, final_prop,
                             mode, polar)
    if coord_split:
        out, base = out
    field_vec = ndim(Hx) == 1 or ndim(Hy) == 1
    scalar_wl = ndim(wavelength) == 0
    rays = rays_from_outputs(out, consts[:, 0, 7], scalar_wl, field_vec)
    if not (opd_split or coord_split):
        return rays
    if not keep_local_z:
        z_img = positions_from_params(params)[-1]
        rays = rays.replace(z=rays.z + z_img.to(rays.z.dtype))
    if not coord_split:
        base = axial_base(consts, flags)
        return rays, (base[0] if scalar_wl else base)
    # the JAX entry's squeezing of the chief base (pallas_trace.py:
    # 2455-2460)
    if scalar_wl:
        base = base[0]
    if not field_vec:
        base = base[..., 0]
    return rays, base


def split_consts(params, gen, consts):
    """The split mode's constants: a copy of ``consts`` whose surface 1
    measures its vertex gap (column 27) from the launch plane, z = gen[0,
    4], as pallas_trace.py:2383-2386 does (pos[0] is -inf for an infinite
    object). Differentiable."""
    pos = positions_from_params(params)
    consts = consts.clone()
    consts[:, 0, 27] = (pos[1] - gen[0, 4].to(pos.dtype)).to(consts.dtype)
    return consts


def axial_base(consts, flags):
    """The split mode's axial base per wavelength, [W]: sum_k sigma_k n1_k
    gap_k with sigma flipping after each mirror (pallas_trace.py:2462-2476),
    the part of every ray's OPD that the kernel leaves out."""
    sig, sigma = [], 1.0
    for f in flags:
        sig.append(sigma)
        if f.is_refl:
            sigma = -sigma
    sig = torch.tensor(sig, dtype=consts.dtype, device=consts.device)
    return torch.sum(sig * consts[:, :, 3] * consts[:, :, 27], dim=1)


def ndim(v) -> int:
    """Number of dimensions of a tensor, array, sequence or scalar."""
    return v.ndim if isinstance(v, torch.Tensor) else int(np.ndim(v))


def rays_from_outputs(out, wls, scalar_wl: bool, field_vec: bool) -> Rays:
    """``Rays`` from the [8, W, F, n] outputs, with the JAX package's
    squeezing of scalar wavelength and field axes."""
    _, W, F, n = out.shape
    wl_col = wls.to(out.dtype).reshape(W, 1, 1).expand(W, F, n)
    arrs = list(out) + [wl_col]
    if scalar_wl and not field_vec:
        arrs = [a[0, 0] for a in arrs]
    elif scalar_wl:
        arrs = [a[0].reshape(-1) for a in arrs]
    else:
        arrs = [a.reshape(-1) for a in arrs]
    x, y, z, L, M, N, inten, opd, wl = arrs
    return Rays(x=x, y=y, z=z, L=L, M=M, N=N, intensity=inten,
                wavelength=wl, opd=opd)
