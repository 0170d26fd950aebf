"""Launch rays from field and pupil coordinates
(port of ``optiland_pr_tpu/trace/raygen.py``).

Differentiable with respect to the system parameters: EPL and EPD are
paraxial traces.
"""
from __future__ import annotations

import math

import torch

from ..core.rays import Rays, new_rays
from ..system.model import OpticModel, positions_from_params
from .paraxial import Paraxial, trace_generic

__all__ = ["generate_rays", "vig_factor"]


def _field_norms(fields):
    """Per-field |(x, y)| with the double-where sqrt guard (a (0, 0) field
    would otherwise put an inf into the gradient)."""
    s = torch.sum(fields**2, dim=1)
    nz = s > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, s, 1.0)), 0.0)


def vig_factor(model: OpticModel, params, Hx, Hy):
    """Nearest-neighbour vignetting factors over the defined fields, as a
    running minimum over the (few) fields."""
    fields = params["fields"]              # [F, 2]
    vig = params["vig"]                    # [F, 2]
    max_field = torch.max(_field_norms(fields))
    fn = fields / torch.where(max_field == 0, 1.0, max_field)
    Hxa = torch.as_tensor(Hx, dtype=fields.dtype, device=fields.device)
    Hya = torch.as_tensor(Hy, dtype=fields.dtype, device=fields.device)
    best_d2 = (fn[0, 0] - Hxa) ** 2 + (fn[0, 1] - Hya) ** 2
    best_vx = vig[0, 0].expand(best_d2.shape)
    best_vy = vig[0, 1].expand(best_d2.shape)
    for f in range(1, fields.shape[0]):
        d2 = (fn[f, 0] - Hxa) ** 2 + (fn[f, 1] - Hya) ** 2
        closer = d2 < best_d2
        best_vx = torch.where(closer, vig[f, 0], best_vx)
        best_vy = torch.where(closer, vig[f, 1], best_vy)
        best_d2 = torch.minimum(d2, best_d2)
    return best_vx, best_vy


def _max_field(params):
    return torch.max(_field_norms(params["fields"]))


def _starting_z_offset(params, par: Paraxial):
    """EPD - min(z) of the inner surfaces."""
    pos = positions_from_params(params)
    return par.EPD() - torch.min(pos[1:-1])


def _tan_deg(v):
    return torch.tan(v * (math.pi / 180.0))


def _ray_origins(model: OpticModel, params, par: Paraxial, Hx, Hy, Px, Py,
                 vx, vy):
    """Ray origins for each field type."""
    pos = positions_from_params(params)
    max_field = _max_field(params)
    field_x = max_field * Hx
    field_y = max_field * Hy

    if model.field_type == "angle":
        EPL = par.EPL()
        if model._object_infinite:
            EPD = par.EPD()
            offset = _starting_z_offset(params, par)
            x = -_tan_deg(field_x) * (offset + EPL)
            y = -_tan_deg(field_y) * (offset + EPL)
            z = pos[1] - offset
            x0 = Px * EPD / 2 * vx + x
            y0 = Py * EPD / 2 * vy + y
            z0 = z.expand(x0.shape)
        else:
            z0 = pos[0]
            x0 = -_tan_deg(field_x) * (EPL - z0)
            y0 = -_tan_deg(field_y) * (EPL - z0)
            x0, y0, z0 = torch.broadcast_tensors(x0, y0,
                                                 z0 * torch.ones_like(Px))
        return x0, y0, z0

    if model.field_type == "object_height":
        if model._object_infinite:
            raise ValueError("object_height fields require a finite object")
        x0 = field_x * torch.ones_like(Px)
        y0 = field_y * torch.ones_like(Px)
        sag = model.surfaces[0].geometry.sag(params["surfaces"][0]["geom"],
                                             x0, y0)
        return x0, y0, sag + pos[0]

    if model.field_type == "paraxial_image_height":
        stop_idx = model.stop_index
        num_surf = model.num_surfaces
        wl = params["wavelengths"][model.primary_wavelength_idx]
        y_f, _ = trace_generic(model, params, 0.0, 1.0, pos[stop_idx], wl,
                               skip=stop_idx)
        y_img_unit = y_f[-1][0]
        y_r, u_r = trace_generic(model, params, 0.0, 1.0,
                                 pos[-1] - pos[stop_idx], wl, reverse=True,
                                 skip=num_surf - stop_idx)
        y_obj_unit, u_obj_unit = y_r[-1][0], u_r[-1][0]
        if model._object_infinite:
            u_obj_y = u_obj_unit * (field_y / y_img_unit)
            u_obj_x = u_obj_unit * (field_x / y_img_unit)
            EPL = par.EPL()
            EPD = par.EPD()
            offset = _starting_z_offset(params, par)
            x = -u_obj_x * (offset + EPL)
            y = -u_obj_y * (offset + EPL)
            z = pos[1] - offset
            x0 = Px * EPD / 2 * vx + x
            y0 = Py * EPD / 2 * vy + y
            z0 = z.expand(x0.shape)
        else:
            x0 = y_obj_unit * (field_x / y_img_unit) * torch.ones_like(Px)
            y0 = y_obj_unit * (field_y / y_img_unit) * torch.ones_like(Px)
            sag = model.surfaces[0].geometry.sag(
                params["surfaces"][0]["geom"], x0, y0)
            z0 = sag + pos[0]
        return x0, y0, z0

    raise ValueError(f"unknown field type {model.field_type}")


def generate_rays(model: OpticModel, params, Hx, Hy, Px, Py,
                  wavelength) -> Rays:
    """Launch rays aimed at the entrance pupil."""
    par = Paraxial(model, params)
    dt, dev = Px.dtype, Px.device
    Hx = torch.as_tensor(Hx, dtype=dt, device=dev)
    Hy = torch.as_tensor(Hy, dtype=dt, device=dev)
    vxf, vyf = vig_factor(model, params, Hx, Hy)
    vx = 1.0 - vxf
    vy = 1.0 - vyf
    x0, y0, z0 = _ray_origins(model, params, par, Hx, Hy, Px, Py, vx, vy)

    EPL = par.EPL()
    EPD = par.EPD()
    x1 = Px * EPD * vx / 2
    y1 = Py * EPD * vy / 2
    z1 = EPL.expand(Px.shape)

    mag = torch.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2 + (z1 - z0) ** 2)
    is_zero = mag < 1e-9
    mag = torch.where(is_zero, 1.0, mag)
    L = torch.where(is_zero, 0.0, (x1 - x0) / mag)
    M = torch.where(is_zero, 0.0, (y1 - y0) / mag)
    N = torch.where(is_zero, 1.0, (z1 - z0) / mag)
    wl = torch.as_tensor(wavelength, dtype=dt, device=dev).expand(Px.shape)
    return new_rays(x0, y0, z0, L, M, N, intensity=torch.ones_like(Px),
                    wavelength=wl, dtype=dt, device=dev)
