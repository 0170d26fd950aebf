"""Point-spread functions: the FFT PSF and the Huygens-Fresnel PSF (port of
``optiland_pr_tpu/analysis/psf.py``, without the views).

FFT: a uniform pupil grid's wavefront becomes a complex pupil, zero-padded
to the grid size, Fourier-transformed and squared. The port keeps the
complex stage in torch complex dtypes on the pupil's device (cuFFT on the
card); the JAX package's host fallback for a TPU without complex dtypes has
no counterpart here.

Huygens: the direct diffraction sum over (pupil x image) points, K4's
re-referenced Huygens-Fresnel form (``kernels/huygens.py``): on the card
always the CUDA kernel, on the CPU its plain version.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.distributions import generate_distribution
from ..system.model import positions_from_params
from ..trace import real as real_trace
from ..trace.paraxial import system_arrays
from .wavefront import Wavefront

__all__ = ["FFTPSF", "HuygensPSF", "calculate_grid_size",
           "fft_psf_from_pupil", "fft2_centered", "get_working_FNO"]


def calculate_grid_size(num_rays: int):
    """(pupil samples across, FFT grid size), OpticStudio's sizing."""
    eff = int(np.floor(32 * 2 ** ((np.log2(num_rays) - 5) / 2)))
    return eff, num_rays * 2


def fft2_centered(a, pre_ifftshift: bool = False):
    """fftshift(fft2(a)) over the last two axes (optionally ifftshift
    first)."""
    if pre_ifftshift:
        a = torch.fft.ifftshift(a, dim=(-2, -1))
    return torch.fft.fftshift(torch.fft.fft2(a), dim=(-2, -1))


def fft_psf_from_pupil(pupils, grid_size: int):
    """Zero-pad complex pupils [W, n, n] to [W, grid, grid], transform, and
    sum the intensities over W: the PSF [grid, grid], normalized to 100 at
    the peak of an unaberrated uniform pupil."""
    W, n, _ = pupils.shape
    before = (grid_size - n) // 2
    after = before + (grid_size - n) % 2
    amp = fft2_centered(torch.nn.functional.pad(pupils,
                                                (before, after, before,
                                                 after)))
    psf = torch.sum(amp.real ** 2 + amp.imag ** 2, dim=0)
    count = torch.sum(_disk(n, psf.device)).to(psf.dtype)
    return psf / (W * count**2) * 100.0


def _disk(n: int, device):
    """The flattened n x n grid's points inside the unit disk, drawn as the
    uniform pupil distribution draws them (numpy, float64): another dtype
    or linspace would move points on the rim in or out."""
    x = np.linspace(-1, 1, n)
    X, Y = np.meshgrid(x, x)
    return torch.as_tensor((X**2 + Y**2 <= 1).reshape(-1), device=device)


def _scatter_disk(P_flat, inside_mask, values):
    """Place ``values`` (ordered over the masked points) at the in-disk
    positions of the flattened grid."""
    return P_flat.masked_scatter(inside_mask, values.to(P_flat.dtype))


class FFTPSF:
    """FFT-based PSF of one field point, built on ``device`` (default: the
    card) in ``dtype`` (default float64)."""

    def __init__(self, optic, field, wavelength=None, num_rays: int = 128,
                 grid_size: int | None = None, strategy: str = "chief_ray",
                 remove_tilt: bool = False, device=None, dtype=None):
        if grid_size is None:
            if num_rays < 32:
                raise ValueError("num_rays must be >= 32 when grid_size is "
                                 "not specified")
            num_rays, grid_size = calculate_grid_size(num_rays)
        elif grid_size < num_rays:
            raise ValueError("grid_size must be >= num_rays")
        self.optic = optic
        self.field = field
        self.num_rays = num_rays
        self.grid_size = grid_size
        self.wavelengths = [wavelength or optic.primary_wavelength]
        self.wavefront = Wavefront(optic, fields=[field],
                                   wavelengths=self.wavelengths,
                                   num_rays=num_rays, distribution="uniform",
                                   strategy=strategy, remove_tilt=remove_tilt,
                                   device=device, dtype=dtype)
        self.pupils = self._generate_pupils()
        self.psf = fft_psf_from_pupil(self.pupils, grid_size)

    def _generate_pupils(self):
        n = self.num_rays
        pupils = []
        for wl in self.wavelengths:
            d = self.wavefront.get_data(self.field, wl)
            inside = _disk(n, d.opd.device)
            valid = d.intensity > 0
            nvalid = torch.sum(valid)
            mean_valid = torch.where(
                nvalid > 0, torch.sum(torch.where(valid, d.intensity, 0.0))
                / torch.clamp(nvalid, min=1), 1.0)
            amplitude = d.intensity / mean_valid
            vals = amplitude * torch.exp(-2j * torch.pi * d.opd)
            P = torch.zeros(n * n, dtype=vals.dtype, device=vals.device)
            pupils.append(_scatter_disk(P, inside, vals).reshape(n, n))
        return torch.stack(pupils)

    def strehl_ratio(self):
        c = self.grid_size // 2
        return self.psf[c, c] / 100.0


def get_working_FNO(model, params, field, wavelength):
    """Working F-number from four marginal rays and the chief ray."""
    hx, hy = field
    _, n_arr, _ = system_arrays(model, params, wavelength)
    n = n_arr[-1]
    ref = params["wavelengths"]
    Px = torch.tensor([0.0, 0.0, 0.0, 1.0, -1.0], dtype=ref.dtype,
                      device=ref.device)
    Py = torch.tensor([0.0, 1.0, -1.0, 0.0, 0.0], dtype=ref.dtype,
                      device=ref.device)
    rays = real_trace.trace_generic(model, params, hx, hy, Px, Py, wavelength)
    dot = rays.L[0] * rays.L[1:] + rays.M[0] * rays.M[1:] \
        + rays.N[0] * rays.N[1:]
    angles = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    avg_na_sq = torch.mean((n * torch.sin(angles)) ** 2)
    fno = torch.where(avg_na_sq <= 0, torch.inf,
                      1.0 / (2 * torch.sqrt(avg_na_sq)))
    return torch.clamp(fno, max=10000.0)


def _image_surface_pose(model, params):
    """(R, tx, ty, tz) of the image surface in the global frame; R is None
    for an untilted surface."""
    from ..core.transforms import rotation_matrix
    pos = positions_from_params(params)
    spec = model.surfaces[-1]
    tz = pos[-1]
    if spec.has_tilt_decenter:
        cs = params["surfaces"][-1]["cs"]
        return (rotation_matrix(cs["rx"], cs["ry"], cs["rz"]), cs["dx"],
                cs["dy"], tz + cs["dz"])
    return None, 0.0, 0.0, tz


def _image_to_local(model, params, x, y, z):
    """Global points (x, y, z) in the image surface's frame."""
    Rm, tx, ty, tz = _image_surface_pose(model, params)
    if Rm is None:
        return x - tx, y - ty, z - tz
    v = torch.stack([x - tx, y - ty, z - tz]).reshape(3, -1)
    out = Rm.T @ v
    return tuple(out[i].reshape(x.shape) for i in range(3))


def _image_to_global(model, params, x, y, z):
    """Points (x, y, z) of the image surface's frame in the global frame."""
    Rm, tx, ty, tz = _image_surface_pose(model, params)
    if Rm is None:
        return x + tx, y + ty, z + tz
    v = Rm @ torch.stack([x, y, z]).reshape(3, -1)
    return (v[0].reshape(x.shape) + tx, v[1].reshape(x.shape) + ty,
            v[2].reshape(x.shape) + tz)


def _on_sphere(data):
    """The pupil samples of the wavefront ``data``, put back on its reference
    sphere (center ``data.center``, radius ``data.radius``) along their
    direction from the center, in float64. Float32 samples (the kernel
    route) carry R eps of rounding in their distance from the center (4e-6
    mm at R = 60 mm, 5e-4 mm at 6 m), which at k ~ 1e4 / mm turns their
    phase by up to radians; float64 samples move by ~R eps, 1e-8 rad."""
    f64 = torch.float64
    u = [v.to(f64) - torch.as_tensor(c).to(f64) for v, c in
         zip((data.pupil_x, data.pupil_y, data.pupil_z), data.center)]
    scale = torch.as_tensor(data.radius).to(f64) \
        / torch.sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2])
    return tuple(torch.as_tensor(c).to(f64) + v * scale
                 for v, c in zip(u, data.center))


class HuygensPSF:
    """The Huygens-Fresnel PSF of one field point by direct summation,
    built on ``device`` (default: the card) in ``dtype`` (default float64):

        PSF(i) = |sum_p amp_p exp(-ik opd_p) exp(ikR)/R (1 + cos theta)/2|^2

    over the samples of a uniform pupil grid on the exit-pupil reference
    sphere, at the points of an image_size x image_size grid on the image
    surface (through its sag and pose), normalized so that the ideal
    (zero-OPD) pupil of the on-axis field peaks at 100. The sum is K4's
    re-referenced form (``kernels/huygens.py::huygens_fresnel_ref``): two
    launches per PSF, the grid and the one-point normalization."""

    def __init__(self, optic, field, wavelength=None, num_rays: int = 128,
                 image_size: int = 128, strategy: str = "chief_ray",
                 remove_tilt: bool = False, oversample: float | None = None,
                 pixel_pitch: float | None = None, device=None, dtype=None):
        self.optic = optic
        self.model, self.params = optic.build(device, dtype)
        self.device, self.dtype = device, dtype
        self.wavelength = wavelength or optic.primary_wavelength
        self.field = tuple(field)
        self.num_rays = num_rays
        self.image_size = image_size
        self.oversample = oversample
        self.pixel_pitch = pixel_pitch
        self.wavefront = Wavefront(optic, fields=[self.field],
                                   wavelengths=[self.wavelength],
                                   num_rays=num_rays, distribution="uniform",
                                   strategy=strategy, remove_tilt=remove_tilt,
                                   device=device, dtype=dtype)
        self.psf = self._compute_psf()

    def get_data(self, field, wl):
        return self.wavefront.get_data(field, wl)

    def _determine_image_center(self):
        """The centroid of a 6-ring hexapolar bundle's lit rays in the image
        surface's frame, with the bundle's local coordinates."""
        ref = self.params["wavelengths"]
        Px, Py = generate_distribution("hexapolar", 6, dtype=ref.dtype,
                                       device=ref.device)
        hx, hy = self.field
        rays = real_trace.trace_generic(self.model, self.params, hx, hy, Px,
                                        Py, self.wavelength)
        valid = rays.intensity > 0
        rx, ry, _ = _image_to_local(self.model, self.params, rays.x, rays.y,
                                    rays.z)
        nv = torch.clamp(torch.sum(valid), min=1)
        cx = torch.sum(torch.where(valid, rx, 0.0)) / nv
        cy = torch.sum(torch.where(valid, ry, 0.0)) / nv
        return rx, ry, valid, cx, cy

    def _get_image_extent(self):
        """(xmin, xmax, ymin, ymax) of the image window: from the pixel
        pitch if given, else from the cutoff frequency (``oversample``),
        else the larger of the geometric footprint and 5 Airy radii."""
        rx, ry, valid, cx, cy = self._determine_image_center()
        self.cx, self.cy = cx, cy
        wl_mm = self.wavelength * 1e-3
        if self.pixel_pitch is not None:
            extent = 0.5 * self.image_size * self.pixel_pitch
        else:
            fno = get_working_FNO(self.model, self.params, self.field,
                                  self.wavelength)
            if self.oversample is not None:
                f_cutoff = 1.0 / (fno * wl_mm)
                self.pixel_pitch = 1.0 / (2 * self.oversample * f_cutoff)
                extent = 0.5 * self.image_size * self.pixel_pitch
            else:
                geom = torch.max(torch.where(
                    valid, torch.hypot(rx - cx, ry - cy), 0.0))
                extent = torch.maximum(geom, 5.0 * fno * 1.22 * wl_mm)
                self.pixel_pitch = 2 * extent / self.image_size
        return cx - extent, cx + extent, cy - extent, cy + extent

    def _get_image_coordinates(self):
        """The image grid in the global frame: (x, y) spaced evenly in the
        image surface's frame, z its sag there."""
        xmin, xmax, ymin, ymax = self._get_image_extent()
        n = self.image_size
        ref = self.params["wavelengths"]
        frac = torch.arange(n, dtype=ref.dtype, device=ref.device) \
            / max(n - 1, 1)
        gx = xmin + (xmax - xmin) * frac
        gy = ymin + (ymax - ymin) * frac
        Y, X = torch.meshgrid(gy, gx, indexing="ij")
        spec = self.model.surfaces[-1]
        Z = spec.geometry.sag(self.params["surfaces"][-1]["geom"],
                              X.reshape(-1), Y.reshape(-1))
        Z = torch.broadcast_to(torch.as_tensor(Z, dtype=X.dtype,
                                               device=X.device),
                               (n * n,)).reshape(X.shape)
        self.x_grid, self.y_grid = gx, gy
        return _image_to_global(self.model, self.params, X, Y, Z)

    def _sum(self, data, opd_mm, ix, iy, iz):
        """The Huygens-Fresnel sum of the wavefront ``data`` (OPD in mm) at
        the image points; pupil samples that are not finite contribute 0."""
        from ..kernels.huygens import huygens_fresnel_ref
        k = 2 * math.pi / (self.wavelength * 1e-3)
        finite = (torch.isfinite(data.pupil_x) & torch.isfinite(data.pupil_y)
                  & torch.isfinite(data.pupil_z) & torch.isfinite(opd_mm))
        pupil = _on_sphere(data)
        px = torch.where(finite, pupil[0], 0.0)
        py = torch.where(finite, pupil[1], 0.0)
        pz = torch.where(finite, pupil[2], 1.0)
        amp = torch.where(finite, data.intensity, 0.0)
        opd = torch.where(finite, opd_mm, 0.0)
        return huygens_fresnel_ref(px, py, pz, amp, opd, ix.reshape(-1),
                                   iy.reshape(-1), iz.reshape(-1), k,
                                   data.radius).reshape(ix.shape)

    def _get_normalization(self, data):
        """The peak of the ideal (zero-OPD) PSF of the on-axis field, at the
        image vertex."""
        if self.field == (0.0, 0.0):
            d0 = data
        else:
            wf = Wavefront(self.optic, fields=[(0, 0)],
                           wavelengths=[self.wavelength],
                           num_rays=self.num_rays, distribution="uniform",
                           device=self.device, dtype=self.dtype)
            d0 = wf.get_data((0, 0), self.wavelength)
        pos = positions_from_params(self.params)
        one = torch.zeros((1, 1), dtype=pos.dtype, device=pos.device)
        ideal = self._sum(d0, torch.zeros_like(d0.opd), one, one,
                          pos[-1].reshape(1, 1))
        return ideal[0, 0]

    def _compute_psf(self):
        data = self.get_data(self.field, self.wavelength)
        ix, iy, iz = self._get_image_coordinates()
        psf = self._sum(data, data.opd * (self.wavelength * 1e-3), ix, iy, iz)
        return psf / self._get_normalization(data) * 100.0

    def strehl_ratio(self):
        c = self.image_size // 2
        return self.psf[c, c] / 100.0
