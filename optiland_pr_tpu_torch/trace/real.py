"""Eager real-ray trace (port of ``optiland_pr_tpu/trace/real.py``).

This is the port's CPU path, the reference every other engine is held
against, and differentiable by autograd. The surface loop runs eagerly over
the static surface list; ray validity is carried by a mask, never by dropping
rays.

Lost rays (missed surface, TIR) keep finite placeholder state through every
surface and get NaN once, at the end (``_nanify``), so a zero cotangent never
meets a NaN partial in the backward pass.
"""
from __future__ import annotations

import torch

from ..core import rays as R
from ..core.transforms import globalize, localize, rotation_matrix
from ..system.model import OpticModel, positions_from_params
from .raygen import generate_rays, vig_factor

__all__ = ["trace_surface", "trace_system", "trace", "trace_generic"]


def _pre_material(model: OpticModel, params, k: int):
    spec = model.surfaces[k - 1]
    return model.surfaces[spec.material_src].material, \
        params["surfaces"][spec.material_src]["material"]


def _post_material(model: OpticModel, params, k: int):
    spec = model.surfaces[k]
    return model.surfaces[spec.material_src].material, \
        params["surfaces"][spec.material_src]["material"]


def trace_surface(model: OpticModel, params, k: int, rays: R.Rays,
                  positions, wl_scalar=None, valid=None):
    """Trace rays through surface k; returns (rays, valid).

    ``wl_scalar``: when the whole bundle shares one wavelength, dispersion is
    evaluated once on the scalar instead of per ray, which is also how the
    kernel's per-wavelength constants compute n(λ)."""
    spec = model.surfaces[k]
    sp = params["surfaces"][k]
    wl = rays.wavelength if wl_scalar is None else wl_scalar

    tz = positions[k]
    if spec.has_tilt_decenter:
        cs = sp["cs"]
        Rm = rotation_matrix(cs["rx"], cs["ry"], cs["rz"])
        x, y, z, L, M, N = localize(Rm, cs["dx"], cs["dy"], tz + cs["dz"],
                                    rays.x, rays.y, rays.z,
                                    rays.L, rays.M, rays.N)
        rays = rays.replace(x=x, y=y, z=z, L=L, M=M, N=N)
    else:
        rays = rays.replace(z=rays.z - tz)

    # ---- intersect, propagate through the pre-material, OPD ---------------
    mat1, mp1 = _pre_material(model, params, k)
    t = spec.geometry.distance(sp["geom"], rays.x, rays.y, rays.z,
                               rays.L, rays.M, rays.N)
    ok_t = torch.isfinite(t)
    t = torch.where(ok_t, t, 0.0)
    valid = ok_t if valid is None else (valid & ok_t)
    n1 = mat1.n(mp1, wl)
    alpha = None
    if mat1.absorbing:
        alpha = 4.0 * torch.pi * mat1.k(mp1, wl) / wl
    rays = R.propagate(rays, t, alpha=alpha)
    rays = rays.replace(opd=rays.opd + torch.abs(t * n1))

    if spec.aperture is not None:
        inside = spec.aperture.contains(sp["aperture"], rays.x, rays.y)
        rays = R.clip(rays, ~inside)

    # ---- refract or reflect -------------------------------------------------
    nx, ny, nz = spec.geometry.normal(sp["geom"], rays.x, rays.y)
    if spec.is_reflective:
        rays, ok_i = R.reflect(rays, nx, ny, nz)
    else:
        mat2, mp2 = _post_material(model, params, k)
        rays, ok_i = R.refract(rays, nx, ny, nz, n1, mat2.n(mp2, wl))
    valid = valid & ok_i

    # scalar intensity coating, after the interaction; a polarization-
    # dependent coating acts on the polarization chain, which is not ported
    coating = spec.coating
    if coating is not None and not coating.polarization_dependent:
        factor = coating.intensity_factor(sp["coating"], spec.is_reflective)
        rays = rays.replace(intensity=rays.intensity * factor)

    if spec.has_tilt_decenter:
        x, y, z, L, M, N = globalize(Rm, cs["dx"], cs["dy"], tz + cs["dz"],
                                     rays.x, rays.y, rays.z,
                                     rays.L, rays.M, rays.N)
        rays = rays.replace(x=x, y=y, z=z, L=L, M=M, N=N)
    else:
        rays = rays.replace(z=rays.z + tz)
    return rays, valid


def _nanify(rays: R.Rays, valid) -> R.Rays:
    """NaN into the kinematic state and OPD of lost rays, once, at the end;
    intensity is never NaN'd."""
    def m(v):
        return torch.where(valid, v, torch.nan)
    return rays.replace(x=m(rays.x), y=m(rays.y), z=m(rays.z),
                        L=m(rays.L), M=m(rays.M), N=m(rays.N),
                        opd=m(rays.opd))


def trace_system(model: OpticModel, params, rays: R.Rays, wl_scalar=None):
    """Trace rays through every surface; returns the final rays, with NaN
    state for lost rays."""
    positions = positions_from_params(params)
    valid = torch.ones_like(rays.x, dtype=torch.bool)
    for k in range(1, model.num_surfaces):
        rays, valid = trace_surface(model, params, k, rays, positions,
                                    wl_scalar=wl_scalar, valid=valid)
    return _nanify(rays, valid)


def _final_image_propagation(params, rays):
    """Propagate past the image surface by its thickness (a no-op for 0).
    The direction is sanitized where it is NaN so that the thickness
    gradient never mixes in a NaN; positions stay NaN via the sum."""
    t_img = params["surfaces"][-1]["thickness"]
    ok = torch.isfinite(rays.L) & torch.isfinite(rays.M) & torch.isfinite(rays.N)
    return rays.replace(x=rays.x + t_img * torch.where(ok, rays.L, 0.0),
                        y=rays.y + t_img * torch.where(ok, rays.M, 0.0),
                        z=rays.z + t_img * torch.where(ok, rays.N, 0.0))


def trace(model: OpticModel, params, Hx, Hy, wavelength, Px, Py,
          final_prop: bool = True):
    """Launch, trace and propagate to the image.

    Hx/Hy are scalars or [F] tensors; Px/Py are [P] pupil samples. Rays are
    field-major: ray i*P+j is field i, pupil point j. ``wavelength`` is a
    scalar."""
    dt, dev = Px.dtype, Px.device
    Hx = torch.atleast_1d(torch.as_tensor(Hx, dtype=dt, device=dev))
    Hy = torch.atleast_1d(torch.as_tensor(Hy, dtype=dt, device=dev))
    Hx, Hy = torch.broadcast_tensors(Hx, Hy)
    P = Px.shape[0]
    F = Hx.shape[0]
    rays = generate_rays(model, params, Hx.repeat_interleave(P),
                         Hy.repeat_interleave(P), Px.repeat(F), Py.repeat(F),
                         wavelength)
    wl = torch.as_tensor(wavelength, dtype=dt, device=dev)
    rays = trace_system(model, params, rays, wl_scalar=wl)
    if final_prop:
        rays = _final_image_propagation(params, rays)
    return rays


def trace_generic(model: OpticModel, params, Hx, Hy, Px, Py, wavelength):
    """Trace explicitly given (field, pupil) coordinates, broadcast against
    each other, to the image, with the vignetting scale on the pupil
    coordinates (``optiland_pr_tpu/trace/real.py:332-350``; the recorded
    ray history, ``record=True``, is not ported)."""
    ref = params["wavelengths"]
    dt, dev = ref.dtype, ref.device

    def as1d(v):
        return torch.atleast_1d(torch.as_tensor(v, dtype=dt, device=dev))
    Hx, Hy, Px, Py = torch.broadcast_tensors(as1d(Hx), as1d(Hy), as1d(Px),
                                             as1d(Py))
    vx, vy = vig_factor(model, params, Hx, Hy)
    rays = generate_rays(model, params, Hx, Hy, Px * (1 - vx),
                         Py * (1 - vy), wavelength)
    wl = torch.as_tensor(wavelength, dtype=dt, device=dev)
    rays = trace_system(model, params, rays,
                        wl_scalar=wl if wl.ndim == 0 else None)
    return _final_image_propagation(params, rays)
