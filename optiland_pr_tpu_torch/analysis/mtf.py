"""The FFT modulation transfer function (port of ``FFTMTF`` of
``optiland_pr_tpu/analysis/mtf.py``, without the view; the geometric MTF
waits for a later slice)."""
from __future__ import annotations

import torch

from ..trace.paraxial import Paraxial
from .psf import FFTPSF, fft2_centered

__all__ = ["FFTMTF"]


class FFTMTF:
    """The MTF as |FFT(PSF)| along the tangential and sagittal axes, built
    on ``device`` (default: the card) in ``dtype`` (default float64)."""

    def __init__(self, optic, field=(0, 0), wavelength=None,
                 num_rays: int = 128, grid_size: int | None = None,
                 max_freq: str | float = "cutoff", device=None, dtype=None):
        self.optic = optic
        wavelength = wavelength or optic.primary_wavelength
        self.wavelength = wavelength
        self.psf_obj = FFTPSF(optic, field, wavelength, num_rays=num_rays,
                              grid_size=grid_size, device=device, dtype=dtype)
        mtf2d = torch.abs(fft2_centered(self.psf_obj.psf,
                                        pre_ifftshift=True))
        c = self.psf_obj.grid_size // 2
        mtf2d = mtf2d / mtf2d[c, c]
        self.mtf_tangential = mtf2d[c:, c]
        self.mtf_sagittal = mtf2d[c, c:]

        # the frequency axis: PSF pixel pitch dx = lambda FNO num_rays / grid
        fno = Paraxial(*optic.build(device, dtype)).FNO()
        lam_mm = wavelength * 1e-3
        dx = lam_mm * fno * self.psf_obj.num_rays / self.psf_obj.grid_size
        self.freq = torch.arange(c, dtype=mtf2d.dtype,
                                 device=mtf2d.device) \
            / (dx * self.psf_obj.grid_size)
        self.cutoff = 1.0 / (lam_mm * fno)
        self.max_freq = self.cutoff if max_freq == "cutoff" else max_freq
