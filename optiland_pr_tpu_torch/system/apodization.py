"""Pupil apodization profiles (port of ``optiland_pr_tpu/system/apodization.py``):
Uniform, Gaussian, CosineSquared, Hann, Tukey, SuperGaussian, Polynomial.

Each is a callable ``(Px, Py) -> intensity`` over normalized pupil
coordinates, given to the trace through ``Optic.set_apodization`` or the
``apodization`` argument of ``generate_rays``/``final_rays``. Each also
reports what the kernels read (``kernel_params``): its code in
``APOD_KINDS`` and up to four numbers, the constants its closed form
divides or compares by, computed in float64 as the JAX profile computes them
before a float32 operation rounds them. K1 evaluates the profile on the
launch intensity (``kernels/gen_trace.py``, ``csrc/gen_trace_common.cuh``).
Any other callable runs the eager trace.
"""
from __future__ import annotations

import math

import torch

__all__ = ["UniformApodization", "GaussianApodization",
           "CosineSquaredApodization", "HannApodization", "TukeyApodization",
           "SuperGaussianApodization", "PolynomialApodization", "APOD_KINDS",
           "kernel_apodization"]

# the kernels' apodization codes (gen column 11), "none" for no profile
APOD_KINDS = ("none", "uniform", "gaussian", "cosine_squared", "hann",
              "tukey", "super_gaussian", "polynomial")


def _radius(Px, Py):
    return torch.sqrt(Px**2 + Py**2)


class BaseApodization:
    kind = "base"

    def __call__(self, Px, Py):
        return self.get_intensity(Px, Py)

    def get_intensity(self, Px, Py):
        raise NotImplementedError

    def kernel_params(self) -> tuple:
        """(code in ``APOD_KINDS``, up to four float64 constants)."""
        raise NotImplementedError


class UniformApodization(BaseApodization):
    kind = "uniform"

    def get_intensity(self, Px, Py):
        return torch.ones_like(Px)

    def kernel_params(self):
        return APOD_KINDS.index(self.kind), ()


class GaussianApodization(BaseApodization):
    """exp(-(Px^2 + Py^2) / (2 sigma^2))."""
    kind = "gaussian"

    def __init__(self, sigma: float = 1.0):
        self.sigma = sigma

    def get_intensity(self, Px, Py):
        return torch.exp(-(Px**2 + Py**2) / (2 * self.sigma**2))

    def kernel_params(self):
        return APOD_KINDS.index(self.kind), (2 * self.sigma**2,)


class CosineSquaredApodization(BaseApodization):
    """cos^2(pi r / (2 R)) inside r < R, else 0."""
    kind = "cosine_squared"

    def __init__(self, R: float = 1.0):
        self.R = R

    def get_intensity(self, Px, Py):
        r = _radius(Px, Py)
        intensity = torch.cos(math.pi * r / (2 * self.R)) ** 2
        return torch.where(r < self.R, intensity, 0.0)

    def kernel_params(self):
        return APOD_KINDS.index(self.kind), (2 * self.R, self.R)


class HannApodization(BaseApodization):
    """(1 - cos(2 pi r / D)) / 2 inside r < D / 2, else 0."""
    kind = "hann"

    def __init__(self, D: float = 2.0):
        self.D = D

    def get_intensity(self, Px, Py):
        r = _radius(Px, Py)
        intensity = 0.5 * (1 - torch.cos(2 * math.pi * r / self.D))
        return torch.where(r < self.D / 2, intensity, 0.0)

    def kernel_params(self):
        return APOD_KINDS.index(self.kind), (self.D, self.D / 2)


class TukeyApodization(BaseApodization):
    """1 up to R (1 - alpha / 2), a cosine taper to 0 at R, 0 beyond."""
    kind = "tukey"

    def __init__(self, R: float = 1.0, alpha: float = 0.5):
        self.R = R
        self.alpha = alpha

    def get_intensity(self, Px, Py):
        r = _radius(Px, Py)
        flat_end = self.R * (1 - self.alpha / 2)
        cos_arg = math.pi * (r - flat_end) / (self.R * self.alpha / 2)
        taper = 0.5 * (1 + torch.cos(cos_arg))
        out = torch.where(r <= flat_end, 1.0, taper)
        return torch.where(r <= self.R, out, 0.0)

    def kernel_params(self):
        return APOD_KINDS.index(self.kind), (
            self.R * (1 - self.alpha / 2), self.R * self.alpha / 2, self.R)


class SuperGaussianApodization(BaseApodization):
    """exp(-(r / w)^n)."""
    kind = "super_gaussian"

    def __init__(self, w: float = 1.0, n: float = 4.0):
        self.w = w
        self.n = n

    def get_intensity(self, Px, Py):
        r = _radius(Px, Py)
        return torch.exp(-((r / self.w) ** self.n))

    def kernel_params(self):
        return APOD_KINDS.index(self.kind), (self.w, self.n)


class PolynomialApodization(BaseApodization):
    """(1 - (r / R)^2)^p inside r < R, else 0. The power's base is replaced
    by 1 outside before the power is taken (the double where), so a
    non-integer p puts no NaN into the pupil cotangents there."""
    kind = "polynomial"

    def __init__(self, R: float = 1.0, p: float = 1.0):
        self.R = R
        self.p = p

    def get_intensity(self, Px, Py):
        r = _radius(Px, Py)
        inside = r < self.R
        base = torch.where(inside, 1 - (r / self.R) ** 2, 1.0)
        return torch.where(inside, base ** self.p, 0.0)

    def kernel_params(self):
        return APOD_KINDS.index(self.kind), (self.R, self.p)


_KERNEL_PROFILES = (UniformApodization, GaussianApodization,
                    CosineSquaredApodization, HannApodization,
                    TukeyApodization, SuperGaussianApodization,
                    PolynomialApodization)


def kernel_apodization(apodization) -> bool:
    """Whether K1 evaluates ``apodization`` itself: no apodization, or one
    of the seven closed-form profiles (``_apod_supported`` of the JAX
    engine). Any other callable runs the eager trace."""
    return apodization is None or isinstance(apodization, _KERNEL_PROFILES)
