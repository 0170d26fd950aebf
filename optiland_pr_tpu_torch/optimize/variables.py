"""Optimization variables: typed views into the parameter tree (port of
``optiland_pr_tpu/optimize/variables.py``).

A variable is (path into the tree, scaler, bounds). ``apply`` is pure: it
returns a new tree whose replaced leaves are new tensors, and it writes into
no tensor in place, so autograd sees every step from the variable vector to
the merit.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .scaling import ReciprocalScaler, get_scaler

__all__ = ["Variable", "VariableList", "make_variable", "NOT_PORTED"]

# variable types of the JAX package whose leaves the port's parameter tree
# does not have yet (ROADMAP.md)
NOT_PORTED = ("f", "grid_sag", "nurbs_ctrlpt", "nurbs_control_point",
              "nurbs_weight", "material")


@dataclasses.dataclass
class Variable:
    """One scalar degree of freedom."""
    path: tuple                     # e.g. ("surfaces", 3, "geom", "radius")
    element: tuple | None = None    # index into a tensor leaf, e.g. (2,)
    scaler: Any = None
    min_val: float | None = None
    max_val: float | None = None
    name: str = ""

    def get(self, params):
        leaf = params
        for k in self.path:
            leaf = leaf[k]
        if self.element is not None:
            leaf = leaf[self.element]
        return leaf

    def set(self, params, value):
        """Pure update: a new tree with this leaf replaced."""
        return _set_path(params, self.path, self.element, value)

    def scaled_value(self, params):
        return self.scaler.scale(self.get(params))

    def set_scaled(self, params, scaled):
        return self.set(params, self.scaler.inverse_scale(scaled))


def _set_path(obj, path, element, value):
    if not path:
        value = torch.as_tensor(value, dtype=obj.dtype, device=obj.device)
        if element is None:
            return value.reshape(obj.shape)
        index = tuple(torch.as_tensor(i, device=obj.device) for i in element)
        return torch.index_put(obj, index, value)
    k = path[0]
    if isinstance(obj, dict):
        new = dict(obj)
    elif isinstance(obj, list):
        new = list(obj)
    else:
        raise TypeError(f"cannot descend into {type(obj)}")
    new[k] = _set_path(obj[k], path[1:], element, value)
    return new


_PATHS = {
    "radius": ("geom", "radius"),
    "reciprocal_radius": ("geom", "radius"),
    "conic": ("geom", "conic"),
    "thickness": ("thickness",),
    "index": ("material", "n"),
    "abbe": ("material", "abbe"),
    "decenter_x": ("cs", "dx"),
    "decenter_y": ("cs", "dy"),
    "decenter_z": ("cs", "dz"),
    "tilt_x": ("cs", "rx"),
    "tilt_y": ("cs", "ry"),
    "tilt_z": ("cs", "rz"),
    "norm_radius": ("geom", "norm_radius"),
    "norm_x": ("geom", "norm_x"),
    "norm_y": ("geom", "norm_y"),
    # a grating's period (um): the geometry's leaf, where the tree holds it
    # (the JAX package's variable points at ("grating", "period"), which
    # its tree does not have: ROADMAP.md section 3)
    "grating_period": ("geom", "grating_period"),
}


def make_variable(model, variable_type: str, surface_number: int = None,
                  scaler=None, min_val=None, max_val=None, **kw) -> Variable:
    """A Variable for a reference-style variable type: radius,
    reciprocal_radius, conic, thickness, index, abbe, decenter_x/y/z and
    tilt_x/y/z (on surfaces built with a tilt or decenter), asphere_coeff
    (``coeff_number=i`` of an even or odd asphere), polynomial_coeff,
    chebyshev_coeff and zernike_coeff (``coeff_index=(i, j)`` of a grid or
    ``coeff_number=i``), norm_radius (Zernike), norm_x and norm_y
    (Chebyshev), grating_period (a grating surface's period), or ``path``
    (``path=...``, optional ``element=...``). The JAX package's other types
    (``NOT_PORTED``) raise NotImplementedError."""
    t = variable_type
    if t in _PATHS:
        v = Variable(("surfaces", surface_number) + _PATHS[t])
        if t == "reciprocal_radius":
            v.scaler = ReciprocalScaler()
    elif t == "asphere_coeff":
        v = Variable(("surfaces", surface_number, "geom", "coefficients"),
                     element=(kw["coeff_number"],))
    elif t in ("polynomial_coeff", "chebyshev_coeff", "zernike_coeff"):
        idx = kw.get("coeff_index", kw.get("coeff_number"))
        v = Variable(("surfaces", surface_number, "geom", "coefficients"),
                     element=tuple(idx) if isinstance(idx, (tuple, list))
                     else (idx,))
    elif t == "path":
        v = Variable(tuple(kw["path"]), element=kw.get("element"))
    elif t in NOT_PORTED:
        raise NotImplementedError(
            f"variable type {t!r} is not ported yet: the port's parameter "
            "tree has no such leaf (ROADMAP.md)")
    else:
        raise ValueError(f"unknown variable type {variable_type!r}")
    if v.scaler is None:
        v.scaler = get_scaler(scaler)
    v.min_val = min_val
    v.max_val = max_val
    v.name = f"{t}@{surface_number}"
    return v


class VariableList:
    """An ordered set of variables with vector <-> tree conversion."""

    def __init__(self):
        self._vars: list[Variable] = []

    def append(self, v: Variable):
        self._vars.append(v)

    def __len__(self):
        return len(self._vars)

    def __iter__(self):
        return iter(self._vars)

    def __getitem__(self, i):
        return self._vars[i]

    def to_vector(self, params):
        """Scaled variable values as a flat vector."""
        return torch.stack([v.scaled_value(params).reshape(())
                            for v in self._vars])

    def apply(self, params, x):
        """Pure: the tree with the scaled vector ``x`` written in."""
        out = params
        for i, v in enumerate(self._vars):
            out = v.set_scaled(out, x[i])
        return out

    def bounds(self):
        return ([v.min_val for v in self._vars],
                [v.max_val for v in self._vars])
