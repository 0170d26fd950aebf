"""The user-facing system builder (port of ``optiland_pr_tpu/system/optic.py``
for standard, plane, even/odd aspheric, XY-polynomial, Chebyshev, biconic,
toroidal, Zernike, Forbes Qbfs/Q2D and thin Fresnel surfaces that refract
or reflect, with
radial apertures, simple and Fresnel coatings and tilts/decenters), with
pickups and solves, an object-space telecentric launch, a pupil apodization
and a launch polarization.

``Optic`` is a mutable host-side builder; ``build(device, dtype)`` compiles it
into a static ``OpticModel`` and a parameter tree of tensors on ``device``.
All tracing and analysis runs on pure functions of (model, params).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import default_float, resolve_device
from ..core.distributions import generate_distribution
from ..geometry import (Biconic, ChebyshevSag, EvenAsphere, ForbesQ2d,
                        ForbesQbfs, FresnelDesignedSag, FresnelZoneSag,
                        OddAsphere, Plane, PolynomialXY, StandardGeometry,
                        Toroidal, ZernikeSag)
from ..materials import resolve_material
from ..materials.base import Mirror
from ..trace.paraxial import Paraxial
from ..utils.convert import params_from_numpy
from ..utils.hostvals import host_isinf
from .apertures import configure_aperture
from .coatings import FresnelCoating
from .model import OpticModel, SurfaceDef, make_surface_params

__all__ = ["Optic"]

_GEOMETRY_BUILDERS = {
    "standard": lambda kw: StandardGeometry(),
    "plane": lambda kw: Plane(),
    "even_asphere": lambda kw: EvenAsphere(len(kw.get("coefficients")
                                               or [])),
    "odd_asphere": lambda kw: OddAsphere(len(kw.get("coefficients") or [])),
    "polynomial": lambda kw: PolynomialXY(*_shape2d(kw.get("coefficients"))),
    "chebyshev": lambda kw: ChebyshevSag(*_shape2d(kw.get("coefficients"))),
    "biconic": lambda kw: Biconic(),
    "toroidal": lambda kw: Toroidal(len(kw.get("coeffs_poly_y") or [])),
    "zernike": lambda kw: ZernikeSag(len(kw.get("coefficients") or []),
                                     kw.get("zernike_type", "standard")),
    "fresnel_zone": lambda kw: FresnelZoneSag(),
    "fresnel_designed": lambda kw: FresnelDesignedSag(),
    "forbes_qbfs": lambda kw: ForbesQbfs(
        len(kw.get("coefficients") or [])
        or (max(kw.get("radial_terms", {0: 0}).keys()) + 1)),
    "forbes_q2d": lambda kw: ForbesQ2d(tuple(kw["terms"])),
}


def _shape2d(coeffs) -> tuple:
    """(num_x, num_y) of a coefficient grid; (1, 1) for none."""
    if coeffs is None:
        return (1, 1)
    return np.atleast_2d(np.asarray(coeffs)).shape


class Optic:
    """Sequential optical system builder; the usage mirrors the JAX package::

        lens = Optic()
        lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
        lens.add_surface(index=1, radius=22.01, thickness=3.26, material="SK16")
        ...
        lens.set_aperture(aperture_type="EPD", value=10)
        lens.set_field_type(field_type="angle")
        lens.add_field(y=14)
        lens.add_wavelength(value=0.55, is_primary=True)
        model, params = lens.build(dtype=torch.float32)   # on the card
    """

    def __init__(self, name: str | None = None):
        self.name = name
        self._surfaces: list[dict] = []
        self.ap_type: str = "EPD"
        self.ap_value: float = 1.0
        self.field_type: str = "angle"
        self.fields: list[tuple] = []       # (x, y, vx, vy)
        self.wavelengths: list[float] = []
        self.primary_wavelength_idx: int = 0
        self.apodization = None         # callable (Px, Py) -> intensity
        self.polarization = "ignore"    # | "unpolarized" | PolarizationState
        self.constraints: list = []     # pickups and solves
        self._telecentric = False
        self._cache: dict = {}

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def add_surface(self, index: int | None = None,
                    surface_type: str = "standard", radius=math.inf,
                    thickness=0.0, conic=0.0, material=None,
                    is_stop: bool = False, comment: str = "", dx=0.0, dy=0.0,
                    dz=0.0, rx=0.0, ry=0.0, rz=0.0, aperture=None,
                    coating=None, **geom_kw):
        """Add (or insert) a surface. The ported surface types are
        ``standard``, ``plane``, ``even_asphere`` and ``odd_asphere`` (with
        ``coefficients=[...]``), ``polynomial`` and ``chebyshev`` (a
        coefficient grid, Chebyshev with ``norm_x``/``norm_y``), ``biconic``
        (``radius_x``, ``conic_x``), ``toroidal`` (``radius_rot``,
        ``coeffs_poly_y``), ``zernike`` (``coefficients``, ``zernike_type``,
        ``norm_radius``), ``forbes_qbfs`` (``coefficients`` or
        ``radial_terms``, ``norm_radius``), ``forbes_q2d`` (``terms``,
        ``coefficients``, ``norm_radius``), ``fresnel_zone`` (``zone_depth``)
        and ``fresnel_designed`` (``focal_length``, ``n_design``); others
        raise at ``build``. ``coating`` is a ``CoatingDef`` or ``"fresnel"``."""
        entry = dict(surface_type=surface_type, radius=radius,
                     thickness=thickness, conic=conic, material=material,
                     is_stop=is_stop, comment=comment, dx=dx, dy=dy, dz=dz,
                     rx=rx, ry=ry, rz=rz, aperture=aperture, coating=coating,
                     geom_kw=geom_kw)
        if index is None or index == len(self._surfaces):
            self._surfaces.append(entry)
        else:
            self._surfaces.insert(index, entry)
        self._dirty()
        return self

    def set_aperture(self, aperture_type: str, value: float):
        if aperture_type not in ("EPD", "imageFNO", "objectNA",
                                 "float_by_stop_size"):
            raise ValueError(f"unknown aperture type {aperture_type}")
        self.ap_type = aperture_type
        self.ap_value = float(value)
        self._dirty()

    def set_field_type(self, field_type: str):
        if field_type not in ("angle", "object_height",
                              "paraxial_image_height"):
            raise ValueError(f"unknown field type {field_type}")
        self.field_type = field_type
        self._dirty()

    def add_field(self, y: float, x: float = 0.0, vx: float = 0.0,
                  vy: float = 0.0):
        self.fields.append((float(x), float(y), float(vx), float(vy)))
        self._dirty()

    def add_wavelength(self, value: float, is_primary: bool = False,
                       unit: str = "um"):
        scale = {"um": 1.0, "nm": 1e-3, "mm": 1e3}[unit]
        self.wavelengths.append(float(value) * scale)
        if is_primary or len(self.wavelengths) == 1:
            self.primary_wavelength_idx = len(self.wavelengths) - 1
        self._dirty()

    @property
    def obj_space_telecentric(self) -> bool:
        """An object-space telecentric launch: every ray leaves the object
        parallel to the axis's chief direction (the JAX sample sets it as
        a plain attribute after adding the surfaces; setting it drops every
        cached build)."""
        return self._telecentric

    @obj_space_telecentric.setter
    def obj_space_telecentric(self, value: bool):
        self._telecentric = bool(value)
        self._dirty()

    def set_apodization(self, apodization):
        """The pupil apodization applied at ray generation
        (``system/apodization.py``)."""
        self.apodization = apodization
        self._dirty()

    def set_polarization(self, state):
        """The launch polarization: "ignore" (no polarization chain, the
        default), "unpolarized", or a ``core.polarization.PolarizationState``.
        A polarized trace carries the Jones chain through every surface and
        applies the Fresnel coatings' s/p coefficients; setting it drops
        every cached build."""
        self.polarization = state
        self._dirty()

    @property
    def polarization_state(self):
        """The launch ``PolarizationState``, or None for "ignore" and
        "unpolarized"."""
        return None if isinstance(self.polarization, str) \
            else self.polarization

    def image_solve(self):
        """Move the image plane to the paraxial focus: the marginal ray's
        height 0 at the image."""
        self.add_solve("marginal_ray_height",
                       surface_idx=len(self._surfaces) - 1, height=0.0)

    def add_pickup(self, source_surface_idx, attr_type, target_surface_idx,
                   scale=1.0, offset=0.0):
        """target.attr = scale * source.attr + offset at every build."""
        from .constraints import Pickup
        self.constraints.append(Pickup(source_surface_idx, attr_type,
                                       target_surface_idx, scale, offset))
        self._dirty()

    def add_solve(self, solve_type, surface_idx=None, height=0.0, **kw):
        """A solve applied at every build: ``marginal_ray_height``,
        ``chief_ray_height`` or ``quick_focus``."""
        from .constraints import (ChiefRayHeightSolve, MarginalRayHeightSolve,
                                  QuickFocusSolve)
        if solve_type == "marginal_ray_height":
            c = MarginalRayHeightSolve(surface_idx, height)
        elif solve_type == "chief_ray_height":
            c = ChiefRayHeightSolve(surface_idx, height)
        elif solve_type == "quick_focus":
            c = QuickFocusSolve(**kw)
        else:
            raise ValueError(f"unknown solve type {solve_type}")
        self.constraints.append(c)
        self._dirty()

    # -- prescription edits -------------------------------------------------
    def set_radius(self, value, surface_number: int):
        self._surfaces[surface_number]["radius"] = float(value)
        self._surfaces[surface_number]["geom_kw"].pop("radius", None)
        self._dirty()

    def set_conic(self, value, surface_number: int):
        self._surfaces[surface_number]["conic"] = float(value)
        self._surfaces[surface_number]["geom_kw"].pop("conic", None)
        self._dirty()

    def set_thickness(self, value, surface_number: int):
        self._surfaces[surface_number]["thickness"] = float(value)
        self._dirty()

    def set_asphere_coeff(self, value, surface_number: int,
                          aspher_coeff_idx: int):
        """Set one aspheric coefficient, extending the list with zeros."""
        kw = self._surfaces[surface_number]["geom_kw"]
        coeffs = list(kw.get("coefficients") or [])
        while len(coeffs) <= aspher_coeff_idx:
            coeffs.append(0.0)
        coeffs[aspher_coeff_idx] = float(value)
        kw["coefficients"] = coeffs
        self._dirty()

    def set_norm_radius(self, value, surface_number: int):
        """Set the normalization radius of a Zernike or Forbes surface."""
        self._surfaces[surface_number]["geom_kw"]["norm_radius"] = \
            float(value)
        self._dirty()

    def scale_system(self, scale_factor: float):
        """Scale every length by ``scale_factor``: finite radii and
        thicknesses, the EPD (or float-by-stop-size) aperture value and every
        physical-aperture dimension. Aspheric coefficients are left as they
        are, as in the JAX package."""
        for e in self._surfaces:
            if math.isfinite(float(e["radius"])):
                e["radius"] = float(e["radius"]) * scale_factor
            if math.isfinite(float(e["thickness"])):
                e["thickness"] = float(e["thickness"]) * scale_factor
            if e.get("aperture") is not None:
                ap_def, ap_params = configure_aperture(e["aperture"])
                e["aperture"] = (ap_def, {k: v * scale_factor
                                          for k, v in ap_params.items()})
        if self.ap_type in ("EPD", "float_by_stop_size"):
            self.ap_value *= scale_factor
        self._dirty()

    def _dirty(self):
        """Drop every cached build after an edit."""
        self._cache = {}

    # ------------------------------------------------------------------
    # compile
    # ------------------------------------------------------------------
    def build(self, device=None, dtype=None):
        """Compile to (OpticModel, params) with every parameter a tensor of
        ``dtype`` (default float64) on ``device`` (default: the card,
        ``config.default_device()``; pass ``device="cpu"`` for the CPU).
        Pickups and solves are applied to the float64 tree on the host
        first, so every device and dtype gets the same solved values."""
        dtype = dtype or default_float()
        device = resolve_device(device)
        key = self.cache_key(device, dtype)
        if key in self._cache:
            return self._cache[key]
        if len(self._surfaces) < 2:
            raise ValueError("need at least object and image surfaces")

        specs, sparams = [], []
        last_material_src = 0
        for k, e in enumerate(self._surfaces):
            if e["surface_type"] not in _GEOMETRY_BUILDERS:
                raise NotImplementedError(
                    f"surface type {e['surface_type']!r} is not ported yet")
            gkw = dict(e["geom_kw"])
            gkw.setdefault("radius", e["radius"])
            gkw.setdefault("conic", e["conic"])
            geometry = _GEOMETRY_BUILDERS[e["surface_type"]](gkw)
            # the inf-ness of a radius is structure: read it from the host
            # input, never from a device tensor
            geometry.radius_is_inf = host_isinf(gkw.get("radius"), False)
            if isinstance(geometry, Toroidal):
                geometry.radius_rot_is_inf = host_isinf(
                    gkw.get("radius_rot", math.inf), False)

            mat_spec = e["material"]
            is_reflective = isinstance(mat_spec, str) and \
                mat_spec.lower() == "mirror"
            if is_reflective:
                material_model, material_src, mat_params = \
                    Mirror(), last_material_src, {}
            else:
                material_model, mat_params = resolve_material(mat_spec)
                material_src = last_material_src = k

            ap_def, ap_params = configure_aperture(e["aperture"])
            coating = e["coating"]
            if isinstance(coating, str):
                if coating.lower() != "fresnel":
                    raise ValueError(f"unknown coating spec {coating!r}")
                coating = FresnelCoating()
            has_td = any(float(e[kk]) != 0.0
                         for kk in ("dx", "dy", "dz", "rx", "ry", "rz"))
            spec = SurfaceDef(
                geometry=geometry,
                # a mirror keeps the pre-material
                material=(specs[material_src].material if is_reflective
                          else material_model),
                material_src=material_src, is_reflective=is_reflective,
                is_stop=bool(e["is_stop"]), aperture=ap_def,
                has_tilt_decenter=has_td, is_object=k == 0,
                is_image=k == len(self._surfaces) - 1, coating=coating,
                comment=e["comment"])
            specs.append(spec)
            cs_kw = {kk: e[kk] for kk in ("dx", "dy", "dz", "rx", "ry", "rz")}
            sparams.append(make_surface_params(spec, e["thickness"], gkw,
                                               mat_params, ap_params, cs_kw))

        model = OpticModel(
            surfaces=tuple(specs), ap_type=self.ap_type,
            field_type=self.field_type, num_fields=len(self.fields),
            num_wavelengths=len(self.wavelengths),
            primary_wavelength_idx=self.primary_wavelength_idx,
            obj_space_telecentric=self._telecentric,
            polarization=self.polarization,
            _object_infinite=host_isinf(self._surfaces[0]["thickness"]))
        host = {
            "surfaces": sparams,
            "aperture_value": self.ap_value,
            "fields": np.asarray([(f[0], f[1]) for f in self.fields]
                                 or [(0., 0.)], np.float64),
            "vig": np.asarray([(f[2], f[3]) for f in self.fields]
                              or [(0., 0.)], np.float64),
            "wavelengths": np.asarray(self.wavelengths or [0.55], np.float64),
        }
        if self.constraints:
            from .constraints import apply_constraints
            host = apply_constraints(
                model, params_from_numpy(host, "cpu", torch.float64),
                self.constraints)
        self._cache[key] = (model, params_from_numpy(host, device, dtype))
        return self._cache[key]

    @staticmethod
    def cache_key(device, dtype) -> tuple:
        """The key of ``build``'s cache for a (device, dtype) pair."""
        return (str(resolve_device(device)), dtype or default_float())

    @property
    def model(self) -> OpticModel:
        return self.build()[0]

    @property
    def params(self):
        return self.build()[1]

    @property
    def primary_wavelength(self) -> float:
        return self.wavelengths[self.primary_wavelength_idx]

    @property
    def paraxial(self) -> Paraxial:
        return Paraxial(*self.build())

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def trace(self, Hx=0.0, Hy=0.0, wavelength=None, num_rays: int = 100,
              distribution: str = "hexapolar", engine: str = "auto",
              device=None, dtype=None):
        """Trace a pupil distribution at one field point and wavelength to
        the image on ``device`` (default: the card), with the optic's
        apodization. ``engine``: "auto" (K1 on a CUDA device when eligible,
        else eager), "eager" or "kernel" (raise if ineligible)."""
        from ..trace.engine import final_rays
        model, params = self.build(device, dtype)
        wavelength = wavelength or self.primary_wavelength
        ref = params["wavelengths"]
        Px, Py = generate_distribution(distribution, num_rays,
                                       dtype=ref.dtype, device=ref.device)
        return final_rays(model, params, Hx, Hy, wavelength, Px, Py,
                          final_prop=True, engine=engine,
                          apodization=self.apodization)
