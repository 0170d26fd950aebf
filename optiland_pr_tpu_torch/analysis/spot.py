"""Spot diagram and encircled energy (port of the functional core of
``optiland_pr_tpu/analysis/spot.py``).

One engine-dispatched call traces the whole fields x wavelengths grid (on the
card, one K1 launch); the statistics are reductions over the ray axis of
[F, W, N] tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.distributions import generate_distribution
from ..system.model import OpticModel, field_coords

__all__ = ["SpotData", "spot_diagram", "spot_from_rays", "encircled_energy"]


@dataclasses.dataclass
class SpotData:
    """Stacked image-plane spot data: tensors of shape [F, W, N]."""
    x: torch.Tensor
    y: torch.Tensor
    intensity: torch.Tensor
    fields: tuple
    wavelengths: tuple
    ref_wl_idx: int = 0   # index of the primary wavelength in ``wavelengths``

    def centroid(self, ref_wl_idx: int | None = None):
        """(cx, cy)[F] of the reference-wavelength spot."""
        i = self.ref_wl_idx if ref_wl_idx is None else ref_wl_idx
        return (torch.mean(self.x[:, i, :], dim=-1),
                torch.mean(self.y[:, i, :], dim=-1))

    def _centered(self, ref_wl_idx: int | None = None):
        cx, cy = self.centroid(ref_wl_idx)
        return self.x - cx[:, None, None], self.y - cy[:, None, None]

    def rms_spot_radius(self, ref_wl_idx: int | None = None):
        """RMS spot radius [F, W]."""
        xc, yc = self._centered(ref_wl_idx)
        return torch.sqrt(torch.mean(xc**2 + yc**2, dim=-1))

    def geometric_spot_radius(self, ref_wl_idx: int | None = None):
        """Largest spot radius [F, W]."""
        xc, yc = self._centered(ref_wl_idx)
        return torch.amax(torch.sqrt(xc**2 + yc**2), dim=-1)


def spot_from_rays(rays, fields, wavelengths, ref_idx: int) -> SpotData:
    """SpotData from final rays in (wavelength, field, pupil) order."""
    W, F = len(wavelengths), len(fields)

    def grid(v):
        return torch.movedim(v.reshape(W, F, -1), 0, 1)
    return SpotData(x=grid(rays.x), y=grid(rays.y),
                    intensity=grid(rays.intensity), fields=tuple(fields),
                    wavelengths=tuple(wavelengths), ref_wl_idx=ref_idx)


def spot_diagram(model: OpticModel, params, fields=None, wavelengths=None,
                 num_rays: int = 100, distribution: str = "hexapolar"
                 ) -> SpotData:
    """Trace all fields x wavelengths and collect image-plane spots."""
    from ..trace.engine import final_rays

    if fields is None:
        fields = field_coords(params)
    if wavelengths is None:
        wavelengths = [float(w) for w in params["wavelengths"].tolist()]
    ref = params["wavelengths"]
    Px, Py = generate_distribution(distribution, num_rays, dtype=ref.dtype,
                                   device=ref.device)
    wls = torch.as_tensor(wavelengths, dtype=ref.dtype, device=ref.device)
    Hx = torch.as_tensor([f[0] for f in fields], dtype=ref.dtype,
                         device=ref.device)
    Hy = torch.as_tensor([f[1] for f in fields], dtype=ref.dtype,
                         device=ref.device)
    rays = final_rays(model, params, Hx, Hy, wls, Px, Py)
    # the primary wavelength anchors the centroid
    prim = float(params["wavelengths"][model.primary_wavelength_idx])
    ref_idx = wavelengths.index(prim) if prim in wavelengths else 0
    return spot_from_rays(rays, fields, wavelengths, ref_idx)


def encircled_energy(spot: SpotData, radii, ref_wl_idx: int | None = None):
    """Intensity-weighted fraction of rays within ``radii`` of the centroid,
    [F, W, len(radii)]."""
    xc, yc = spot._centered(ref_wl_idx)
    r = torch.sqrt(xc**2 + yc**2)
    w = spot.intensity
    total = torch.sum(w, dim=-1)
    radii = torch.as_tensor(radii, dtype=r.dtype, device=r.device)
    inside = (r[..., None] <= radii) * w[..., None]
    return torch.sum(inside, dim=-2) / total[..., None]
