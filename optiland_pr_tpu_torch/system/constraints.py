"""Pickups and solves as parameter transforms
(port of ``optiland_pr_tpu/system/constraints.py``).

Each pickup or solve is a differentiable function ``params -> params``
applied before tracing; ``apply_constraints`` composes them left to right.
``Optic.build`` applies them to the host float64 tree, as the JAX package's
build does under x64, and only then moves the tree to its device and dtype.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.safe_math import safe_div
from .model import OpticModel

__all__ = ["Pickup", "MarginalRayHeightSolve", "ChiefRayHeightSolve",
           "QuickFocusSolve", "apply_constraints"]

_ATTRS = {
    "radius": ("geom", "radius"),
    "conic": ("geom", "conic"),
    "thickness": ("thickness",),
}


def _get(params, surface_idx, path):
    leaf = params["surfaces"][surface_idx]
    for k in path:
        leaf = leaf[k]
    return leaf


def _set(params, surface_idx, path, value):
    """A copy of ``params`` whose leaf at ``path`` of surface
    ``surface_idx`` is ``value`` (in the old leaf's dtype and device)."""
    surfaces = list(params["surfaces"])
    sp = dict(surfaces[surface_idx])
    if len(path) == 1:
        old = sp[path[0]]
        sp[path[0]] = torch.as_tensor(value).to(old)
    else:
        inner = dict(sp[path[0]])
        inner[path[1]] = torch.as_tensor(value).to(inner[path[1]])
        sp[path[0]] = inner
    surfaces[surface_idx] = sp
    out = dict(params)
    out["surfaces"] = surfaces
    return out


@dataclasses.dataclass(frozen=True)
class Pickup:
    """target.attr = scale * source.attr + offset."""
    source_surface_idx: int
    attr_type: str
    target_surface_idx: int
    scale: float = 1.0
    offset: float = 0.0

    def __call__(self, model: OpticModel, params):
        path = _ATTRS[self.attr_type]
        v = _get(params, self.source_surface_idx, path)
        return _set(params, self.target_surface_idx, path,
                    self.scale * v + self.offset)


@dataclasses.dataclass(frozen=True)
class _RayHeightSolve:
    """Adjust the thickness before ``surface_idx`` so that the chosen
    paraxial ray reaches ``height`` there: shift = (height - y[k]) / u[k].

    The JAX package's quirk is kept on purpose: the divisor is ``u[k]``, the
    slope recorded at the target surface after its interaction, not the
    slope in the gap being adjusted."""
    surface_idx: int
    height: float = 0.0
    _chief: bool = False

    def __call__(self, model: OpticModel, params):
        from ..trace.paraxial import Paraxial
        par = Paraxial(model, params)
        y, u = par.chief_ray() if self._chief else par.marginal_ray()
        y_k = y[self.surface_idx][0]
        u_k = u[self.surface_idx][0]
        shift = safe_div(self.height - y_k, u_k)
        t = _get(params, self.surface_idx - 1, ("thickness",))
        return _set(params, self.surface_idx - 1, ("thickness",), t + shift)


def MarginalRayHeightSolve(surface_idx: int, height: float = 0.0):
    return _RayHeightSolve(surface_idx, height, _chief=False)


def ChiefRayHeightSolve(surface_idx: int, height: float = 0.0):
    return _RayHeightSolve(surface_idx, height, _chief=True)


@dataclasses.dataclass(frozen=True)
class QuickFocusSolve:
    """Move the image plane to the least-squares focus of a traced bundle:
    dz = -<x ux + y uy> / <ux^2 + uy^2> with u = (L, M) / N."""
    Hx: float = 0.0
    Hy: float = 0.0
    wavelength: float | None = None
    num_rays: int = 5
    distribution: str = "hexapolar"

    def __call__(self, model: OpticModel, params):
        from ..core.distributions import generate_distribution
        from ..trace import real as real_trace
        ref = params["wavelengths"]
        wl = self.wavelength or float(ref[model.primary_wavelength_idx])
        Px, Py = generate_distribution(self.distribution, self.num_rays,
                                       dtype=ref.dtype, device=ref.device)
        rays = real_trace.trace(model, params, self.Hx, self.Hy, wl, Px, Py)
        ux = rays.L / rays.N
        uy = rays.M / rays.N
        num = torch.mean(rays.x * ux + rays.y * uy)
        den = torch.mean(ux**2 + uy**2)
        dz = -safe_div(num, den)
        t = _get(params, model.num_surfaces - 2, ("thickness",))
        return _set(params, model.num_surfaces - 2, ("thickness",), t + dz)


def apply_constraints(model: OpticModel, params, constraints):
    """Compose pickups and solves left to right."""
    for c in constraints:
        params = c(model, params)
    return params
