"""Geometry protocol and the closed-form conic intersection
(port of ``optiland_pr_tpu/geometry/base.py``).

A geometry is a static object; its numbers live in a per-surface parameter
dict. This slice ports the conic and plane geometries only: the Newton
intersection that the freeform sags need comes with them in a later slice.
"""
from __future__ import annotations

import torch

from ..core.safe_math import safe_div

__all__ = ["Geometry", "conic_distance", "normalize_normal"]


def normalize_normal(dfdx, dfdy):
    """Unit surface normal from sag partials, with the df/dz = -1 convention."""
    mag = torch.sqrt(dfdx**2 + dfdy**2 + 1.0)
    return dfdx / mag, dfdy / mag, -1.0 / mag


def conic_distance(radius, conic, x, y, z, L, M, N):
    """Closed-form ray/conic intersection, the root nearest the vertex plane;
    infinite radius (plane) and the degenerate a == 0 case are handled without
    branches.

    Conditioned for low precision exactly as the JAX package: the ray is first
    advanced to the vertex plane, and the two roots are paired
    citardauq-style (near root = c/q, q = -(b/2 + sign(b/2) sqrt(disc)))."""
    is_plane = torch.isinf(radius)
    R = torch.where(is_plane, 1.0, radius)

    t0 = torch.where(torch.abs(N) > 1e-8, safe_div(-z, N), 0.0)
    x0 = x + t0 * L
    y0 = y + t0 * M
    z0 = z + t0 * N

    a = conic * N**2 + L**2 + M**2 + N**2
    bh = conic * N * z0 + L * x0 + M * y0 + N * z0 - N * R
    c = conic * z0**2 - 2 * R * z0 + x0**2 + y0**2 + z0**2

    d = bh**2 - a * c
    ok = d >= 0
    sqrt_d = torch.sqrt(torch.where(ok, d, 1.0))

    # sign-of-bh pairing with sign(0) := 1
    q = -(bh + torch.where(bh >= 0, 1.0, -1.0) * sqrt_d)
    t_far = safe_div(q, a)
    t_near = safe_div(c, q)
    tq = torch.where(torch.abs(z0 + t_near * N) <= torch.abs(z0 + t_far * N),
                     t_near, t_far)
    tq = torch.where(a == 0, t_near, tq)
    t = t0 + torch.where(ok, tq, torch.nan)   # NaN: the ray misses the conic
    return torch.where(is_plane, t0, t)


class Geometry:
    """Base geometry. Subclasses define ``kind``, ``sag``, ``sag_grad`` and
    ``distance``.

    ``radius_is_inf`` is a host-side hint stamped by ``Optic.build()`` from
    the user's inputs, so that ``model_flags`` never reads a device value.
    """

    kind: str = "base"
    radius_is_inf: bool | None = None

    def default_params(self, **kw) -> dict:
        raise NotImplementedError

    def sag(self, p, x, y):
        raise NotImplementedError

    def sag_grad(self, p, x, y):
        raise NotImplementedError

    def normal(self, p, x, y):
        dfdx, dfdy = self.sag_grad(p, x, y)
        return normalize_normal(dfdx, dfdy)

    def distance(self, p, x, y, z, L, M, N):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"
