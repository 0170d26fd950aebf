"""The Huygens MTF (port of ``HuygensMTF`` of
``optiland_pr_tpu/analysis/psf_mtf_extra.py``; ``MMDFTPSF``, ``SampledMTF``
and ``ThroughFocusMTF`` wait for a later slice)."""
from __future__ import annotations

import torch

from ..system.model import field_coords
from .psf import HuygensPSF, fft2_centered

__all__ = ["HuygensMTF"]


class HuygensMTF:
    """The MTF from the Huygens-Fresnel PSF: per field, a PSF sampled at
    twice the optical cutoff (``oversample=2``), |FFT| along the tangential
    and sagittal axes clipped to [0, 1] and normalized by its DC value.
    Built on ``device`` (default: the card) in ``dtype`` (default float64).
    ``max_freq`` is accepted as the JAX package accepts it, and unused."""

    def __init__(self, optic, fields="all", wavelength=None,
                 num_rays: int = 64, image_size: int = 128,
                 max_freq="cutoff", device=None, dtype=None):
        wavelength = wavelength or optic.primary_wavelength
        if fields == "all":
            _, params = optic.build(device, dtype)
            fields = field_coords(params)
        self.fields = fields
        self.wavelength = wavelength
        self.image_size = image_size
        self.psf_instances = []
        self.mtf = []
        c = image_size // 2
        for f in fields:
            p = HuygensPSF(optic, f, wavelength, num_rays=num_rays,
                           image_size=image_size, oversample=2.0,
                           device=device, dtype=dtype)
            self.psf_instances.append(p)
            mtf2d = torch.abs(fft2_centered(p.psf))
            dc = mtf2d[c, c]
            self.mtf.append([torch.clamp(mtf2d[c:, c][:c] / dc, 0.0, 1.0),
                             torch.clamp(mtf2d[c, c:][:c] / dc, 0.0, 1.0)])
        pitch = self.psf_instances[0].pixel_pitch
        ref = self.mtf[0][0]
        self.freq = torch.arange(c, dtype=ref.dtype, device=ref.device) \
            * (1.0 / (image_size * pitch))
        self.mtf_tangential = self.mtf[0][0]
        self.mtf_sagittal = self.mtf[0][1]
