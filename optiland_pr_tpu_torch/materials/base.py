"""Material models: static structure + parameterized n(λ)/k(λ)
(port of ``optiland_pr_tpu/materials/base.py``).

A material is a static model object; its numbers (constants, dispersion
coefficients, tabulated data) live in the parameter tree. ``default_params``
returns host values (Python floats and numpy arrays); ``Optic.build`` turns the
whole tree into tensors on the chosen device and dtype in one pass.

The data files are the JAX package's own (``optiland_pr_tpu/data``), found by
path so that importing the port never imports the JAX package.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .dispersion import evaluate_formula, nair_edlen

__all__ = ["MaterialModel", "IdealMaterial", "AbbeMaterial", "FormulaMaterial",
           "TabulatedMaterial", "AIR", "MIRROR", "Mirror", "DATA_DIR", "interp"]

DATA_DIR = Path(__file__).resolve().parents[2] / "optiland_pr_tpu" / "data"


def interp(x, xp, fp):
    """``jnp.interp`` on tensors: linear interpolation, clamped to the end
    values outside [xp[0], xp[-1]]."""
    x = torch.as_tensor(x, dtype=xp.dtype, device=xp.device)
    i = torch.clamp(torch.searchsorted(xp, x.reshape(-1), right=True),
                    1, xp.shape[0] - 1).reshape(x.shape)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float64 if xp.dtype == torch.float64
                                    else np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _wl(wavelength_um, p_like):
    """The wavelength as a tensor of the parameters' dtype and device."""
    return torch.as_tensor(wavelength_um, dtype=p_like.dtype,
                           device=p_like.device)


class MaterialModel:
    kind: str = "base"

    def default_params(self, **kw) -> dict:
        raise NotImplementedError

    def n(self, p, wavelength_um):
        raise NotImplementedError

    def k(self, p, wavelength_um):
        return torch.zeros_like(torch.as_tensor(wavelength_um))

    @property
    def absorbing(self) -> bool:
        """Static hint: True if k may be nonzero (enables attenuation)."""
        return False

    def __repr__(self):
        return f"{type(self).__name__}()"


class IdealMaterial(MaterialModel):
    """Constant n, k."""

    kind = "ideal"

    def __init__(self, n: float = 1.0, k: float = 0.0,
                 absorbing: bool | None = None):
        self._n = n
        self._k = k
        self._absorbing = (k != 0.0) if absorbing is None else absorbing

    def default_params(self, n=None, k=None, **kw) -> dict:
        return {"n": float(self._n if n is None else n),
                "k": float(self._k if k is None else k)}

    def n(self, p, wavelength_um):
        return p["n"] * torch.ones_like(_wl(wavelength_um, p["n"]))

    def k(self, p, wavelength_um):
        return p["k"] * torch.ones_like(_wl(wavelength_um, p["k"]))

    @property
    def absorbing(self):
        return self._absorbing


_ABBE_COEFFS = None


def _abbe_model_coefficients():
    """The Schott-catalog polynomial fit matrix shipped with the JAX package."""
    global _ABBE_COEFFS
    if _ABBE_COEFFS is None:
        _ABBE_COEFFS = np.load(DATA_DIR / "abbe_model_coefficients.npy")
    return _ABBE_COEFFS


class AbbeMaterial(MaterialModel):
    """n from (n_d, V_d) via a polynomial fit to Schott catalog data.
    Valid 0.380-0.750 um."""

    kind = "abbe"

    def default_params(self, n=1.5, abbe=50.0, **kw) -> dict:
        return {"index": float(n), "abbe": float(abbe)}

    def n(self, p, wavelength_um):
        nd, vd = p["index"], p["abbe"]
        coeffs = torch.as_tensor(_abbe_model_coefficients(), dtype=nd.dtype,
                                 device=nd.device)
        X = torch.stack([nd, vd, nd**2, vd**2, nd**3, vd**3])
        poly = X @ coeffs
        w = _wl(wavelength_um, nd)
        y = torch.zeros_like(w)
        for c in poly:                    # Horner, as jnp.polyval
            y = y * w + c
        return y


class FormulaMaterial(MaterialModel):
    """Dispersion-formula material with an optional tabulated extinction
    coefficient and optional Schott thermal data."""

    kind = "formula"

    def __init__(self, formula_id: int, num_coefficients: int,
                 has_k_table: bool = False, k_table_len: int = 0,
                 has_thermal: bool = False):
        self.formula_id = int(formula_id)
        self.num_coefficients = int(num_coefficients)
        self.has_k_table = bool(has_k_table)
        self.k_table_len = int(k_table_len)
        self.has_thermal = bool(has_thermal)

    def default_params(self, coefficients=None, k_wavelength=None,
                       k_values=None, t0_celsius=None, thermal_dispersion=None,
                       **kw) -> dict:
        c = np.zeros((self.num_coefficients,))
        if coefficients is not None:
            c = np.asarray(coefficients, np.float64)
        p = {"coefficients": c}
        if self.has_k_table:
            p["k_wavelength"] = np.asarray(k_wavelength, np.float64)
            p["k_values"] = np.asarray(k_values, np.float64)
        if self.has_thermal:
            p["t0_celsius"] = float(20.0 if t0_celsius is None
                                    else t0_celsius)
            p["thermal_dispersion"] = np.asarray(
                [0.0] * 6 if thermal_dispersion is None
                else thermal_dispersion, np.float64)
        return p

    def n(self, p, wavelength_um, temperature=None, pressure=None):
        """Catalog index; with ``temperature`` given and thermal data present,
        applies the Schott dn/dT correction and air-index rescaling."""
        w = _wl(wavelength_um, p["coefficients"])
        if temperature is None or not self.has_thermal:
            return evaluate_formula(self.formula_id, p["coefficients"], w)
        pressure = 1.0 if pressure is None else pressure
        t0 = p["t0_celsius"]
        c = p["thermal_dispersion"]
        waverel = w * nair_edlen(w, temperature, pressure) / \
            nair_edlen(w, t0, 1.0)
        base = evaluate_formula(self.formula_id, p["coefficients"], waverel)
        n_abs = base * nair_edlen(w, t0, 1.0)
        dT = temperature - t0
        term1 = c[0] + c[1] * dT + c[2] * dT**2
        term2 = (c[3] + c[4] * dT) / (w**2 - c[5] ** 2)
        dn_abs = (n_abs**2 - 1.0) / (2.0 * n_abs) * (term1 + term2) * dT
        n_abs = n_abs + dn_abs
        return n_abs / nair_edlen(w, temperature, pressure)

    def k(self, p, wavelength_um):
        w = _wl(wavelength_um, p["coefficients"])
        if not self.has_k_table:
            return torch.zeros_like(w)
        return interp(w, p["k_wavelength"], p["k_values"])

    @property
    def absorbing(self):
        return self.has_k_table

    def __repr__(self):
        return (f"FormulaMaterial(formula={self.formula_id}, "
                f"ncoeff={self.num_coefficients})")


class TabulatedMaterial(MaterialModel):
    """Interpolated n (and optionally k) tables."""

    kind = "tabulated"

    def __init__(self, n_table_len: int, has_k_table: bool = False,
                 k_table_len: int = 0):
        self.n_table_len = int(n_table_len)
        self.has_k_table = bool(has_k_table)
        self.k_table_len = int(k_table_len)

    def default_params(self, n_wavelength=None, n_values=None,
                       k_wavelength=None, k_values=None, **kw) -> dict:
        p = {"n_wavelength": np.asarray(n_wavelength, np.float64),
             "n_values": np.asarray(n_values, np.float64)}
        if self.has_k_table:
            p["k_wavelength"] = np.asarray(k_wavelength, np.float64)
            p["k_values"] = np.asarray(k_values, np.float64)
        return p

    def n(self, p, wavelength_um):
        w = _wl(wavelength_um, p["n_wavelength"])
        return interp(w, p["n_wavelength"], p["n_values"])

    def k(self, p, wavelength_um):
        w = _wl(wavelength_um, p["n_wavelength"])
        if not self.has_k_table:
            return torch.zeros_like(w)
        return interp(w, p["k_wavelength"], p["k_values"])

    @property
    def absorbing(self):
        return self.has_k_table


class Mirror(MaterialModel):
    """Sentinel for a reflective surface; the builder keeps the pre-material."""

    kind = "mirror"

    def default_params(self, **kw) -> dict:
        return {}


AIR = IdealMaterial()
MIRROR = Mirror()
