"""Merit-function operands (port of the evaluable subset of
``optiland_pr_tpu/optimize/operands.py``; reference
optiland/optimization/operand/).

Each metric is a differentiable function ``metric(model, params,
**input_data) -> scalar tensor``. Ported: the paraxial EPD, EPL, f2 and FNO,
``total_track`` and ``rms_spot_size`` at the image surface. Every other name
of the JAX package's ``METRIC_DICT`` is registered and raises
NotImplementedError, with what it waits for (ROADMAP.md).
"""
from __future__ import annotations

import functools

import torch

from ..core.distributions import generate_distribution
from ..system.model import positions_from_params
from ..trace.paraxial import Paraxial

__all__ = ["METRIC_DICT", "operand_registry", "register_operand"]


# --- paraxial metrics -----------------------------------------------------

def _paraxial_metric(name):
    def metric(model, params, **kw):
        return getattr(Paraxial(model, params), name)()
    metric.__name__ = name
    return metric


def total_track(model, params, **kw):
    """Distance from the first surface to the image plane (reference
    optimization/operand/paraxial.py total_track)."""
    pos = positions_from_params(params)
    return pos[-1] - pos[1]


# --- real-ray metrics -----------------------------------------------------

@functools.lru_cache(maxsize=16)
def _pupil(distribution, num_rays, dtype, device):
    """Pupil samples, made once per (distribution, size, dtype, device), as
    the JAX package's jit folds them into a constant. Callers must not
    write into them."""
    return generate_distribution(distribution, num_rays, dtype=dtype,
                                 device=device)


def rms_spot_size(model, params, surface_number, Hx, Hy, num_rays, wavelength,
                  distribution="hexapolar", **kw):
    """RMS spot radius at the image surface (reference
    optimization/operand/ray.py:300-341) through ``final_rays``: on the card
    K1 forward and K2 backward.

    A scalar ``wavelength`` drops lost rays from the statistics (finite
    mask); ``"all"`` traces every wavelength, centres on the primary one's
    centroid and, as the JAX package does, does not mask."""
    from ..trace.engine import final_rays
    if surface_number not in (-1, model.num_surfaces - 1):
        raise NotImplementedError(
            "rms_spot_size off the image surface needs the recorded ray "
            "history of trace/real.py, which is not ported yet")
    ref = params["wavelengths"]
    Px, Py = _pupil(distribution, num_rays, ref.dtype, ref.device)
    if isinstance(wavelength, str) and wavelength == "all":
        wls = ref.detach()
        rays = final_rays(model, params, Hx, Hy, wls, Px, Py,
                          final_prop=False)
        n = Px.shape[0]
        xs = [rays.x[i * n:(i + 1) * n] for i in range(wls.shape[0])]
        ys = [rays.y[i * n:(i + 1) * n] for i in range(wls.shape[0])]
        wi = model.primary_wavelength_idx
        mean_x = torch.mean(xs[wi])
        mean_y = torch.mean(ys[wi])
        r2 = torch.cat([(x - mean_x) ** 2 + (y - mean_y) ** 2
                        for x, y in zip(xs, ys)])
        return torch.sqrt(torch.mean(r2))
    rays = final_rays(model, params, Hx, Hy, wavelength, Px, Py,
                      final_prop=False)
    x, y = rays.x, rays.y
    # finite-masked statistics: lost rays (miss/TIR -> NaN) drop out
    ok = torch.isfinite(x) & torch.isfinite(y)
    w = ok.to(x.dtype)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    xs = torch.where(ok, x, 0.0)
    ys = torch.where(ok, y, 0.0)
    mx = torch.sum(xs * w) / wsum
    my = torch.sum(ys * w) / wsum
    r2 = torch.where(ok, (xs - mx) ** 2 + (ys - my) ** 2, 0.0)
    return torch.sqrt(torch.sum(r2) / wsum)


def _not_ported(name, needs):
    def metric(model, params, **kw):
        raise NotImplementedError(
            f"operand {name!r} is not ported yet: it needs {needs} "
            "(ROADMAP.md)")
    metric.__name__ = name
    return metric


_AB_NAMES = ["TSC", "SC", "CC", "TCC", "TAC", "AC", "TPC", "PC", "DC",
             "TAchC", "LchC", "TchC"]
_THIRD_ORDER = "trace/aberrations.py (third-order sums)"
_HISTORY = "the recorded ray history of trace/real.py"

METRIC_DICT = {
    "seidel": _not_ported("seidel", _THIRD_ORDER),
    **{name: _not_ported(name, _THIRD_ORDER) for name in _AB_NAMES},
    **{f"{name}_sum": _not_ported(f"{name}_sum", _THIRD_ORDER)
       for name in _AB_NAMES},
    **{name: _paraxial_metric(name) for name in ["EPD", "EPL", "f2", "FNO"]},
    **{name: _not_ported(name, "Paraxial beyond EPD/EPL/f2/FNO")
       for name in ["f1", "F1", "F2", "P1", "P2", "N1", "N2", "XPD", "XPL",
                    "magnification"]},
    "total_track": total_track,
    **{name: _not_ported(name, _HISTORY)
       for name in ["real_x_intercept", "real_y_intercept",
                    "real_z_intercept", "real_x_intercept_lcs",
                    "real_y_intercept_lcs", "real_z_intercept_lcs",
                    "real_L", "real_M", "real_N", "AOI", "clearance"]},
    "rms_spot_size": rms_spot_size,
    "OPD_difference": _not_ported("OPD_difference",
                                  "analysis/wavefront.py"),
    "edge_thickness": _not_ported("edge_thickness",
                                  "Paraxial marginal and chief rays"),
    "rms_wavefront_error": _not_ported("rms_wavefront_error",
                                       "analysis/wavefront.py"),
}

operand_registry = dict(METRIC_DICT)


def register_operand(name, func, overwrite=False):
    if name in operand_registry and not overwrite:
        raise ValueError(f"Operand {name!r} is already registered.")
    operand_registry[name] = func
