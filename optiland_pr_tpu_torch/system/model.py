"""Static system description (port of ``optiland_pr_tpu/system/model.py``).

- ``OpticModel`` / ``SurfaceDef``: static structure (geometry types, material
  models, stop index, field and wavelength counts, an object-space
  telecentric launch, the launch polarization). Every surface refracts or
  reflects; thin-lens, grating and phase interactions come with later
  slices.
- the parameter tree: every number (radii, conics, asphere coefficients,
  thicknesses, material data, aperture extents, coating factors, tilts and
  decenters, field coordinates, wavelengths) as tensors, so autograd flows
  through all of them.

Surface positions derive from thicknesses (a cumulative sum), so a thickness
gradient moves every downstream surface.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.polarization import PolarizationState
from ..geometry import Geometry
from ..materials.base import MaterialModel
from .apertures import ApertureDef

__all__ = ["SurfaceDef", "OpticModel", "positions_from_params", "field_coords",
           "make_surface_params"]


@dataclasses.dataclass(frozen=True)
class SurfaceDef:
    """Static description of one surface."""
    geometry: Geometry
    material: MaterialModel            # post-material model
    material_src: int                  # surface index owning the post-material params
    is_reflective: bool = False
    is_stop: bool = False
    aperture: ApertureDef | None = None
    has_tilt_decenter: bool = False
    is_object: bool = False
    is_image: bool = False
    coating: Any = None                # CoatingDef | None
    comment: str = ""


@dataclasses.dataclass(frozen=True)
class OpticModel:
    """Static model of the whole system."""
    surfaces: tuple[SurfaceDef, ...]
    ap_type: str = "EPD"               # | "imageFNO" | "objectNA" | "float_by_stop_size"
    field_type: str = "angle"          # | "object_height" | "paraxial_image_height"
    num_fields: int = 0
    num_wavelengths: int = 0
    primary_wavelength_idx: int = 0
    obj_space_telecentric: bool = False
    _object_infinite: bool = True
    # "ignore" (no chain), "unpolarized" or a PolarizationState
    polarization: str | PolarizationState = "ignore"

    @property
    def num_surfaces(self) -> int:
        return len(self.surfaces)

    @property
    def stop_index(self) -> int:
        for i, s in enumerate(self.surfaces):
            if s.is_stop:
                return i
        return 1


def field_coords(params) -> list:
    """Normalized (Hx, Hy) of the defined fields."""
    f = params["fields"].detach().cpu().numpy()
    max_field = float(np.max(np.sqrt(np.sum(f**2, axis=1))))
    if max_field == 0:
        return [(0.0, 0.0)]
    return [(float(x / max_field), float(y / max_field)) for x, y in f]


def positions_from_params(params) -> torch.Tensor:
    """z of every surface vertex, surface 1 at z = 0: positions[0] is
    -thickness[0] (-inf for an infinite object), positions[k] the sum of
    thickness[1..k-1] for k >= 1."""
    t = torch.stack([sp["thickness"] for sp in params["surfaces"]])
    inner = torch.cat([torch.zeros((1,), dtype=t.dtype, device=t.device),
                       torch.cumsum(t[1:-1], 0)])
    return torch.cat([(-t[0])[None], inner])


def make_surface_params(spec: SurfaceDef, thickness, geom_kw: dict,
                        material_params: dict, aperture_params,
                        cs_kw: dict) -> dict:
    """Host parameter dict of one surface (converted to tensors by build)."""
    p = {
        "thickness": float(thickness),
        "geom": spec.geometry.default_params(**geom_kw),
        "material": material_params,
    }
    if spec.aperture is not None:
        p["aperture"] = aperture_params
    if spec.coating is not None:
        p["coating"] = spec.coating.default_params()
    if spec.has_tilt_decenter:
        p["cs"] = {k: float(cs_kw.get(k, 0.0))
                   for k in ("dx", "dy", "dz", "rx", "ry", "rz")}
    return p
