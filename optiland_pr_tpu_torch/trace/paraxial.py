"""Paraxial y-u trace and first-order system properties
(port of ``optiland_pr_tpu/trace/paraxial.py``: EPD, EPL, XPL, f2, FNO
and the marginal and chief rays that the solves read, without the GRIN
gaps).

Every quantity is a differentiable function of (model, params); the surface
loop is a Python loop over a handful of scalars.
"""
from __future__ import annotations

import torch

from ..system.model import OpticModel, positions_from_params

__all__ = ["system_arrays", "trace_generic", "Paraxial"]


def system_arrays(model: OpticModel, params, wavelength):
    """(radii[S], n[S], positions[S]); ``n[k]`` is the index after surface k."""
    radii = torch.stack([sp["geom"]["radius"] for sp in params["surfaces"]])
    ns = []
    for spec in model.surfaces:
        src = spec.material_src
        mat = model.surfaces[src].material
        ns.append(mat.n(params["surfaces"][src]["material"],
                        wavelength).reshape(()))
    return radii, torch.stack(ns), positions_from_params(params)


def trace_generic(model: OpticModel, params, y, u, z, wavelength,
                  reverse: bool = False, skip: int = 0):
    """Trace a paraxial ray; returns stacked (heights, slopes), one row per
    traced surface."""
    R, n, pos = system_arrays(model, params, wavelength)
    specs = list(model.surfaces)
    if reverse:
        R = -torch.flip(R, (0,))
        n = torch.flip(torch.roll(n, shifts=1), (0,))
        pos = pos[-1] - torch.flip(pos, (0,))
        specs = specs[::-1]

    power = torch.diff(n, prepend=n[:1]) / R

    def as1d(v):
        return torch.atleast_1d(torch.as_tensor(v, dtype=R.dtype,
                                                device=R.device))
    y_, u_, z_ = torch.broadcast_tensors(as1d(y), as1d(u), as1d(z))

    heights, slopes = [], []
    for k in range(skip, len(specs)):
        spec = specs[k]
        if spec.is_object:
            heights.append(y_)
            slopes.append(u_)
            continue
        t = pos[k] - z_
        z_ = pos[k].expand(z_.shape)
        y_ = y_ + t * u_
        if spec.is_reflective:
            u_ = -u_ - 2 * y_ / R[k]
        else:
            u_ = (n[k - 1] * u_ - y_ * power[k]) / n[k]
        heights.append(y_)
        slopes.append(u_)
    return torch.stack(heights), torch.stack(slopes)


class Paraxial:
    """First-order properties: a thin stateless facade over
    ``trace_generic``; every method is differentiable."""

    def __init__(self, model: OpticModel, params):
        self.model = model
        self.params = params

    def _wl(self):
        return self.params["wavelengths"][self.model.primary_wavelength_idx]

    def _pos(self):
        return positions_from_params(self.params)

    def _trace(self, y, u, z, reverse=False, skip=0):
        return trace_generic(self.model, self.params, y, u, z, self._wl(),
                             reverse=reverse, skip=skip)

    def f2(self):
        z0 = self._pos()[1] - 1.0
        y, u = self._trace(1.0, 0.0, z0)
        return torch.abs((-y[0] / u[-1])[0])

    def EPL(self):
        stop_index = self.model.stop_index
        pos = self._pos()
        if stop_index == 1:
            return pos[1]
        z0 = pos[-1] - pos[stop_index]
        skip = self.model.num_surfaces - stop_index
        y, u = self._trace(0.0, 0.1, z0, reverse=True, skip=skip)
        return (y[-1] / u[-1])[0]

    def EPD(self):
        m = self.model
        ap_value = self.params["aperture_value"]
        if m.ap_type == "EPD":
            return ap_value
        if m.ap_type == "imageFNO":
            return self.f2() / ap_value
        if m.ap_type == "objectNA":
            obj_z = self._pos()[0]
            src = m.surfaces[0].material_src
            n0 = m.surfaces[src].material.n(
                self.params["surfaces"][src]["material"], self._wl())
            u0 = torch.arcsin(ap_value / n0)
            return 2 * (self.EPL() - obj_z) * torch.tan(u0)
        if m.ap_type == "float_by_stop_size":
            stop_index = m.stop_index
            if m._object_infinite:
                y, _ = self._trace(1.0, 0.0, -1.0)
                return ap_value / y[stop_index][0]
            obj_z = self._pos()[0]
            EPL = self.EPL()
            y, _ = self._trace(0.0, 0.1, obj_z)
            u0 = 0.1 * ap_value / y[stop_index][0]
            return u0 * (EPL - obj_z)
        raise NotImplementedError(f"aperture type {m.ap_type}")

    def XPL(self):
        """Exit-pupil location relative to the image surface: the unit ray
        from the stop's vertex traced forward from the surface after it."""
        stop_index = self.model.stop_index
        z0 = self._pos()[stop_index]
        y, u = self._trace(0.0, 0.1, z0, skip=stop_index + 1)
        return (-y[-1] / u[-1])[0]

    def FNO(self):
        if self.model.ap_type == "imageFNO":
            return self.params["aperture_value"]
        return self.f2() / self.EPD()

    def marginal_ray(self):
        """(heights, slopes) of the marginal ray, one row per surface."""
        EPD = self.EPD()
        pos = self._pos()
        if self.model._object_infinite:
            ya, ua = EPD / 2.0, 0.0
            obj_z = pos[1] - 10.0
        else:
            obj_z = pos[0]
            ya, ua = 0.0, EPD / (2.0 * (self.EPL() - obj_z))
        return self._trace(ya, ua, obj_z)

    def chief_ray(self):
        """(heights, slopes) of the chief ray of the largest y field: a unit
        ray from the stop traced both ways, scaled to the field."""
        m = self.model
        stop_index = m.stop_index
        pos = self._pos()
        y_fwd, _ = self._trace(0.0, 0.1, pos[stop_index], skip=stop_index)
        y_img_unit = y_fwd[-1]
        y_rev, u_rev = self._trace(0.0, 0.1, pos[-1] - pos[stop_index],
                                   reverse=True,
                                   skip=m.num_surfaces - stop_index)
        y_obj_unit, u_obj_unit = y_rev[-1], u_rev[-1]
        scaling = self._scale_chief_ray(y_obj_unit, u_obj_unit, y_img_unit)
        if m.field_type == "paraxial_image_height":
            y_obj_start = y_obj_unit * scaling
        else:
            y_obj_start = -(y_obj_unit * scaling)
        u_obj_start = u_obj_unit * scaling
        if m._object_infinite:
            z1 = pos[1]
            y1 = u_obj_start * (z1 - self.EPL())
            return self._trace(y1, u_obj_start, z1)
        return self._trace(y_obj_start, u_obj_start, pos[0])

    def _scale_chief_ray(self, y_obj_unit, u_obj_unit, y_img_unit):
        """The unit chief ray's scale for the field type."""
        m = self.model
        max_y_field = torch.max(torch.abs(self.params["fields"][:, 1]))
        if m.field_type == "angle":
            return torch.tan(torch.deg2rad(max_y_field)) / u_obj_unit
        if m.field_type == "object_height":
            return max_y_field / y_obj_unit
        if m.field_type == "paraxial_image_height":
            return max_y_field / y_img_unit
        raise ValueError(f"unknown field type {m.field_type}")
