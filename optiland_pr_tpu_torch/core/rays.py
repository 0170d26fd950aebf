"""Ray bundles as dataclasses of tensors (port of ``optiland_pr_tpu/core/rays.py``).

Conventions kept from the JAX package:
- direction cosines (L, M, N) with L^2+M^2+N^2 = 1,
- blocked rays are masked by zeroing ``intensity``, never dropped,
- ``opd`` accumulates |t * n| per propagation step.

A polarized bundle carries ``p``, the per-ray 3x3 polarization matrix chain
[..., n, 3, 3] (``core/polarization.py``); it is None for an unpolarized
one.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import default_device, default_float

__all__ = ["Rays", "new_rays", "propagate", "refract", "reflect", "clip",
           "align_normal"]


@dataclasses.dataclass(frozen=True)
class Rays:
    """A bundle of real rays; every field but ``p`` is a tensor of shape
    [..., n]; ``p`` is the polarization chain [..., n, 3, 3] or None."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    L: torch.Tensor
    M: torch.Tensor
    N: torch.Tensor
    intensity: torch.Tensor
    wavelength: torch.Tensor
    opd: torch.Tensor
    p: torch.Tensor | None = None

    def replace(self, **kw) -> "Rays":
        return dataclasses.replace(self, **kw)


def new_rays(x, y, z, L, M, N, intensity=1.0, wavelength=0.55, opd=None,
             polarized: bool = False, dtype=None, device=None) -> Rays:
    """Build a ray bundle, broadcasting scalars to the common shape. Without
    a ``device`` the bundle lies where its tensor inputs lie, or on the card
    (``config.default_device()``) when all of them are Python numbers.
    ``polarized`` starts the polarization chain ``p`` at the identity."""
    dtype = dtype or default_float()
    if device is None:
        device = next((a.device for a in (x, y, z, L, M, N, intensity,
                                          wavelength, opd)
                       if isinstance(a, torch.Tensor)), default_device())
    arrs = [torch.as_tensor(a, dtype=dtype, device=device)
            for a in (x, y, z, L, M, N, intensity, wavelength)]
    shape = torch.broadcast_shapes(*[a.shape for a in arrs])
    x, y, z, L, M, N, intensity, wavelength = [a.expand(shape) for a in arrs]
    if opd is None:
        opd = torch.zeros(shape, dtype=dtype, device=arrs[0].device)
    else:
        opd = torch.as_tensor(opd, dtype=dtype, device=device).expand(shape)
    p = None
    if polarized:
        p = torch.eye(3, dtype=dtype, device=arrs[0].device).expand(
            shape + (3, 3))
    return Rays(x, y, z, L, M, N, intensity, wavelength, opd, p)


def propagate(rays: Rays, t, alpha=None) -> Rays:
    """Straight-line propagation by distance t. ``alpha`` (per um) is the
    absorption coefficient 4*pi*k/lambda; intensity then decays by
    exp(-alpha * t * 1e3) with t in mm."""
    out = rays.replace(x=rays.x + t * rays.L, y=rays.y + t * rays.M,
                       z=rays.z + t * rays.N)
    if alpha is not None:
        decay = torch.as_tensor(-alpha * t * 1e3, dtype=out.intensity.dtype,
                                device=out.intensity.device)
        out = out.replace(intensity=out.intensity * torch.exp(decay))
    return out


def clip(rays: Rays, blocked) -> Rays:
    """Zero the intensity of rays where ``blocked`` is True."""
    return rays.replace(intensity=torch.where(
        blocked, torch.zeros_like(rays.intensity), rays.intensity))


def align_normal(L, M, N, nx, ny, nz):
    """Flip the normal to oppose the incident direction; returns the aligned
    normal and |cos(theta_i)|."""
    dot = L * nx + M * ny + N * nz
    sgn = torch.sign(dot)
    return nx * sgn, ny * sgn, nz * sgn, torch.abs(dot)


def refract(rays: Rays, nx, ny, nz, n1, n2):
    """Vector Snell refraction. Returns (rays, ok): TIR rays keep a finite
    direction and are flagged in ``ok``; the trace sets NaN at the end."""
    nx, ny, nz, dot = align_normal(rays.L, rays.M, rays.N, nx, ny, nz)
    u = n1 / n2
    disc = 1.0 - u**2 * (1.0 - dot**2)
    ok = disc >= 0
    root = torch.sqrt(torch.where(ok, disc, 0.0))
    tx = u * rays.L + nx * root - u * nx * dot
    ty = u * rays.M + ny * root - u * ny * dot
    tz = u * rays.N + nz * root - u * nz * dot
    return rays.replace(L=tx, M=ty, N=tz), ok


def reflect(rays: Rays, nx, ny, nz):
    """Mirror reflection; returns (rays, ok) like ``refract`` (always ok)."""
    nx, ny, nz, dot = align_normal(rays.L, rays.M, rays.N, nx, ny, nz)
    out = rays.replace(L=rays.L - 2 * dot * nx, M=rays.M - 2 * dot * ny,
                       N=rays.N - 2 * dot * nz)
    return out, torch.ones_like(rays.L, dtype=torch.bool)
