"""Dispersion-formula evaluators, refractiveindex.info formulas 1-9
(port of ``optiland_pr_tpu/materials/dispersion.py``).

Pure functions of (coefficients, wavelength_um) on tensors; the coefficient
count is fixed when the material is built, so the loops unroll.
"""
from __future__ import annotations

import torch

__all__ = ["evaluate_formula", "nair_edlen"]


def _f1(c, w):
    """Sellmeier: n^2 = 1 + c0 + sum c_k w^2/(w^2 - c_{k+1}^2)."""
    w2 = w**2
    n2 = 1.0 + c[0]
    for k in range(1, len(c), 2):
        n2 = n2 + c[k] * w2 / (w2 - c[k + 1] ** 2)
    return torch.sqrt(n2)


def _f2(c, w):
    """Sellmeier-2: n^2 = 1 + c0 + sum c_k w^2/(w^2 - c_{k+1})."""
    w2 = w**2
    n2 = 1.0 + c[0]
    for k in range(1, len(c), 2):
        n2 = n2 + c[k] * w2 / (w2 - c[k + 1])
    return torch.sqrt(n2)


def _f3(c, w):
    """Polynomial: n^2 = c0 + sum c_k w^c_{k+1}."""
    n2 = c[0] * torch.ones_like(w)
    for k in range(1, len(c), 2):
        n2 = n2 + c[k] * w ** c[k + 1]
    return torch.sqrt(n2)


def _f4(c, w):
    """RefractiveIndex.INFO mixed form."""
    w2 = w**2
    n2 = (c[0]
          + c[1] * w ** c[2] / (w2 - c[3] ** c[4])
          + c[5] * w ** c[6] / (w2 - c[7] ** c[8]))
    for k in range(9, len(c), 2):
        n2 = n2 + c[k] * w ** c[k + 1]
    return torch.sqrt(n2)


def _f5(c, w):
    """Cauchy: n = c0 + sum c_k w^c_{k+1}."""
    n = c[0] * torch.ones_like(w)
    for k in range(1, len(c), 2):
        n = n + c[k] * w ** c[k + 1]
    return n


def _f6(c, w):
    """Gases: n = 1 + c0 + sum c_k/(c_{k+1} - w^-2)."""
    inv_w2 = w ** -2.0
    n = 1.0 + c[0]
    for k in range(1, len(c), 2):
        n = n + c[k] / (c[k + 1] - inv_w2)
    return n * torch.ones_like(w)


def _f7(c, w):
    """Herzberger: n = c0 + c1/(w^2-0.028) + c2/(w^2-0.028)^2 + sum c_k w^(2(k-2))."""
    w2 = w**2
    u = 1.0 / (w2 - 0.028)
    n = c[0] + c[1] * u + c[2] * u**2
    for k in range(3, len(c)):
        n = n + c[k] * w ** (2 * (k - 2))
    return n


def _f8(c, w):
    """Retro: b = c0 + c1 w^2/(w^2-c2) + c3 w^2; n^2 = (1+2b)/(1-b)."""
    w2 = w**2
    b = c[0] + c[1] * w2 / (w2 - c[2]) + c[3] * w2
    return torch.sqrt((1.0 + 2.0 * b) / (1.0 - b))


def _f9(c, w):
    """Exotic: n^2 = c0 + c1/(w^2-c2) + c3 (w-c4)/((w-c4)^2+c5)."""
    n2 = (c[0] + c[1] / (w**2 - c[2])
          + c[3] * (w - c[4]) / ((w - c[4]) ** 2 + c[5]))
    return torch.sqrt(n2)


_FORMULAS = {1: _f1, 2: _f2, 3: _f3, 4: _f4, 5: _f5, 6: _f6, 7: _f7, 8: _f8,
             9: _f9}


def evaluate_formula(formula_id: int, coefficients, wavelength_um):
    """Evaluate dispersion formula ``formula_id`` (1-9) at ``wavelength_um``
    (a tensor); ``coefficients`` is a 1-D tensor."""
    if formula_id not in _FORMULAS:
        raise ValueError(f"Unknown dispersion formula id: {formula_id}")
    return _FORMULAS[formula_id](coefficients, wavelength_um)


def nair_edlen(wavelength_um, temp_c, pressure_atm=1.0):
    """Edlen-variant air index used for environmental corrections."""
    w2 = wavelength_um**2
    n_ref_minus_1 = (6432.8 + (2949810.0 * w2) / (146.0 * w2 - 1.0)
                     + (25540.0 * w2) / (41.0 * w2 - 1.0)) * 1e-8
    return 1.0 + (n_ref_minus_1 * pressure_atm) / (
        1.0 + (temp_c - 15.0) * 0.0034785)
