"""Zernike polynomial bases (fringe, Noll and ANSI standard orderings) and
their least-squares fit (port of ``optiland_pr_tpu/core/zernike.py``).

The term tables are computed on the host (the number of terms is static);
the radial polynomials are sums of powers, and the fit is one least-squares
solve, differentiable by autograd. The solve runs in float64 whatever the
data's dtype: on CUDA ``torch.linalg.lstsq`` has only the ``gels`` driver
(full-rank tall systems, no rcond), so the port solves the normal equations
through a pseudo-inverse instead, which also takes rank-deficient fits
(few rings, many terms) and returns their minimum-norm solution as the JAX
package's ``lstsq`` does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["zernike_terms", "zernike_eval", "zernike_design_matrix",
           "ZernikeFit", "noll_indices", "fringe_indices", "standard_indices",
           "lstsq_min_norm"]


def standard_indices(num_terms: int):
    """ANSI-standard ordering: j = (n(n+2)+m)/2."""
    out = []
    n = 0
    while len(out) < num_terms:
        for m in range(-n, n + 1, 2):
            out.append((n, m))
            if len(out) == num_terms:
                break
        n += 1
    return out


def noll_indices(num_terms: int):
    """Noll ordering (j starts at 1)."""
    out = []
    j = 1
    while len(out) < num_terms:
        n = 0
        j1 = j - 1
        while j1 > n:
            n += 1
            j1 -= n
        m = (-1) ** j * ((n % 2) + 2 * int((j1 + ((n + 1) % 2)) / 2.0))
        out.append((n, m))
        j += 1
    return out


def fringe_indices(num_terms: int):
    """Fringe (University of Arizona) ordering."""
    cands = []
    for n in range(0, 20):
        for m in range(-n, n + 1, 2):
            fringe = (1 + (n + abs(m)) / 2) ** 2 - 2 * abs(m) \
                + (1 - np.sign(m)) / 2
            cands.append((fringe, n, m))
    cands.sort(key=lambda t: t[0])
    return [(n, m) for _, n, m in cands[:num_terms]]


_ORDERINGS = {"standard": standard_indices, "noll": noll_indices,
              "fringe": fringe_indices}


def zernike_terms(zernike_type: str, num_terms: int):
    return _ORDERINGS[zernike_type](num_terms)


def _radial_coeffs(n: int, m: int):
    """Coefficients of rho^(n-2k) in R_n^m."""
    m = abs(m)
    out = []
    for k in range((n - m) // 2 + 1):
        c = ((-1) ** k * math.factorial(n - k)
             / (math.factorial(k) * math.factorial((n + m) // 2 - k)
                * math.factorial((n - m) // 2 - k)))
        out.append((n - 2 * k, c))
    return out


def _norm_factor(zernike_type: str, n: int, m: int) -> float:
    """Normalization per basis convention: 1 for fringe, sqrt(n+1) or
    sqrt(2(n+1)) for Noll and ANSI standard."""
    if zernike_type == "fringe":
        return 1.0
    if zernike_type in ("noll", "standard"):
        return math.sqrt(n + 1) if m == 0 else math.sqrt(2 * (n + 1))
    raise ValueError(zernike_type)


def _single_term(zernike_type, n, m, rho, phi):
    Rnm = torch.zeros_like(rho)
    for p, c in _radial_coeffs(n, m):
        Rnm = Rnm + c * rho**p
    norm = _norm_factor(zernike_type, n, m)
    if m > 0:
        ang = torch.cos(m * phi)
    elif m < 0:
        ang = torch.sin(-m * phi)
    else:
        ang = torch.ones_like(phi)
    return norm * Rnm * ang


def zernike_eval(zernike_type: str, coeffs, rho, phi):
    """Sum of coeffs[j] * Z_j(rho, phi); the number of terms is
    len(coeffs)."""
    terms = zernike_terms(zernike_type, len(coeffs))
    out = torch.zeros_like(rho)
    for j, (n, m) in enumerate(terms):
        out = out + coeffs[j] * _single_term(zernike_type, n, m, rho, phi)
    return out


def zernike_design_matrix(zernike_type: str, num_terms: int, rho, phi):
    """[N, num_terms] design matrix of basis values."""
    terms = zernike_terms(zernike_type, num_terms)
    return torch.stack([_single_term(zernike_type, n, m, rho, phi)
                        for (n, m) in terms], dim=-1)


def lstsq_min_norm(A, b):
    """The minimum-norm least-squares solution of A x = b in float64, cast
    back to b's dtype: x = pinv(A^T A) A^T b. Differentiable, and defined
    for rank-deficient A on every device."""
    A64, b64 = A.to(torch.float64), b.to(torch.float64)
    x = torch.linalg.pinv(A64.T @ A64) @ (A64.T @ b64)
    return x.to(b.dtype)


class ZernikeFit:
    """Least-squares Zernike fit of scattered (x, y, z) data; x, y are
    normalized pupil coordinates."""

    def __init__(self, x, y, z, zernike_type: str = "fringe",
                 num_terms: int = 36):
        self.zernike_type = zernike_type
        self.num_terms = num_terms
        rho = torch.sqrt(x**2 + y**2)
        phi = torch.atan2(y, x)
        A = zernike_design_matrix(zernike_type, num_terms, rho, phi)
        self.coeffs = lstsq_min_norm(A, z)
        self._rho, self._phi, self._z = rho, phi, z

    def evaluate(self, rho, phi):
        return zernike_eval(self.zernike_type, self.coeffs, rho, phi)

    @property
    def residual_rms(self):
        fit = self.evaluate(self._rho, self._phi)
        return torch.sqrt(torch.mean((fit - self._z) ** 2))
