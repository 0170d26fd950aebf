"""The FFT point-spread function (port of the FFT part of
``optiland_pr_tpu/analysis/psf.py``, without the views; the Huygens PSF
and its kernel K4 wait for a later slice).

A uniform pupil grid's wavefront becomes a complex pupil, zero-padded to
the grid size, Fourier-transformed and squared. The port keeps the complex
stage in torch complex dtypes on the pupil's device (cuFFT on the card);
the JAX package's host fallback for a TPU without complex dtypes has no
counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..trace import real as real_trace
from ..trace.paraxial import system_arrays
from .wavefront import Wavefront

__all__ = ["FFTPSF", "calculate_grid_size", "fft_psf_from_pupil",
           "get_working_FNO"]


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
