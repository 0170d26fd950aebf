"""The user-facing system builder (port of ``optiland_pr_tpu/system/optic.py``
for standard and plane surfaces that refract or reflect).

``Optic`` is a mutable host-side builder; ``build(device, dtype)`` compiles it
into a static ``OpticModel`` and a parameter tree of tensors on ``device``.
All tracing and analysis runs on pure functions of (model, params).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import default_float
from ..core.distributions import generate_distribution
from ..geometry import Plane, StandardGeometry
from ..materials import resolve_material
from ..materials.base import Mirror
from ..trace.paraxial import Paraxial
from ..utils.convert import params_from_numpy
from ..utils.hostvals import host_isinf
from .apertures import configure_aperture
from .model import OpticModel, SurfaceDef, make_surface_params

__all__ = ["Optic"]

_GEOMETRY_BUILDERS = {
    "standard": StandardGeometry,
    "plane": Plane,
}


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
        model, params = lens.build(device="cuda", dtype=torch.float32)
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
        self._cache: dict = {}

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def add_surface(self, index: int | None = None,
                    surface_type: str = "standard", radius=math.inf,
                    thickness=0.0, conic=0.0, material=None,
                    is_stop: bool = False, comment: str = "", dx=0.0, dy=0.0,
                    dz=0.0, rx=0.0, ry=0.0, rz=0.0, aperture=None, **geom_kw):
        """Add (or insert) a surface. Only ``standard`` and ``plane``
        surface types are ported; others raise at ``build``."""
        entry = dict(surface_type=surface_type, radius=radius,
                     thickness=thickness, conic=conic, material=material,
                     is_stop=is_stop, comment=comment, dx=dx, dy=dy, dz=dz,
                     rx=rx, ry=ry, rz=rz, aperture=aperture, geom_kw=geom_kw)
        if index is None or index == len(self._surfaces):
            self._surfaces.append(entry)
        else:
            self._surfaces.insert(index, entry)
        self._cache = {}
        return self

    def set_aperture(self, aperture_type: str, value: float):
        if aperture_type not in ("EPD", "imageFNO", "objectNA",
                                 "float_by_stop_size"):
            raise ValueError(f"unknown aperture type {aperture_type}")
        self.ap_type = aperture_type
        self.ap_value = float(value)
        self._cache = {}

    def set_field_type(self, field_type: str):
        if field_type not in ("angle", "object_height",
                              "paraxial_image_height"):
            raise ValueError(f"unknown field type {field_type}")
        self.field_type = field_type
        self._cache = {}

    def add_field(self, y: float, x: float = 0.0, vx: float = 0.0,
                  vy: float = 0.0):
        self.fields.append((float(x), float(y), float(vx), float(vy)))
        self._cache = {}

    def add_wavelength(self, value: float, is_primary: bool = False,
                       unit: str = "um"):
        scale = {"um": 1.0, "nm": 1e-3, "mm": 1e3}[unit]
        self.wavelengths.append(float(value) * scale)
        if is_primary or len(self.wavelengths) == 1:
            self.primary_wavelength_idx = len(self.wavelengths) - 1
        self._cache = {}

    # ------------------------------------------------------------------
    # compile
    # ------------------------------------------------------------------
    def build(self, device=None, dtype=None):
        """Compile to (OpticModel, params) with every parameter a tensor of
        ``dtype`` (default float64) on ``device`` (default CPU)."""
        dtype = dtype or default_float()
        key = (str(torch.device(device or "cpu")), dtype)
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
            geometry = _GEOMETRY_BUILDERS[e["surface_type"]]()
            # the inf-ness of a radius is structure: read it from the host
            # input, never from a device tensor
            geometry.radius_is_inf = host_isinf(gkw.get("radius"), False)

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
                is_image=k == len(self._surfaces) - 1, comment=e["comment"])
            specs.append(spec)
            cs_kw = {kk: e[kk] for kk in ("dx", "dy", "dz", "rx", "ry", "rz")}
            sparams.append(make_surface_params(spec, e["thickness"], gkw,
                                               mat_params, ap_params, cs_kw))

        model = OpticModel(
            surfaces=tuple(specs), ap_type=self.ap_type,
            field_type=self.field_type, num_fields=len(self.fields),
            num_wavelengths=len(self.wavelengths),
            primary_wavelength_idx=self.primary_wavelength_idx,
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
        self._cache[key] = (model, params_from_numpy(host, device, dtype))
        return self._cache[key]

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
        the image. ``engine``: "auto" (K1 on a CUDA device when eligible,
        else eager), "eager" or "kernel" (raise if ineligible)."""
        from ..trace.engine import final_rays
        model, params = self.build(device, dtype)
        wavelength = wavelength or self.primary_wavelength
        ref = params["wavelengths"]
        Px, Py = generate_distribution(distribution, num_rays,
                                       dtype=ref.dtype, device=ref.device)
        return final_rays(model, params, Hx, Hy, wavelength, Px, Py,
                          final_prop=True, engine=engine)
