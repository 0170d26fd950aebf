"""Engine dispatch for final-surface ray queries
(port of ``optiland_pr_tpu/trace/engine.py``).

Every spot, operand and analysis call asks ``final_rays`` for the final ray
state. Eligible systems are those ``supports_model`` and ``gen_eligible``
accept (the ported surfaces, the gratings and the constant, radial and
linear-grating phase surfaces among them, and launch modes, the telecentric
one among them; a grid phase profile runs the eager trace), traced without
apodization or with one of the seven closed-form profiles, which K1
evaluates itself, unpolarized or with any launch polarization (K1 carries
the Jones chain, Fresnel coatings included). On a
CUDA device, ``"auto"`` sends every eligible call to the K1 kernel
(``kernels/gen_trace.py``), whose gradient is the K2 kernel
(``kernels/gen_grad.py``): a merit's gradient through such a call runs K2
on the card, never the eager trace. Everything else runs the eager trace
(``trace/real.py``), which works on any device and is differentiable by
autograd. The JAX package's ``_PALLAS_MIN_RAYS`` crossover was measured on a
TPU and is not carried over.

Modes: ``"auto"``, ``"eager"`` and ``"kernel"`` (raise if ineligible; on CPU
tensors the kernel's plain version runs).
"""
from __future__ import annotations

import contextlib

import torch

from ..kernels.gen_trace import (gen_eligible, gen_trace_conic, ndim,
                                 supports_model)
from ..system.apodization import kernel_apodization
from . import real as real_trace

__all__ = ["final_rays", "kernel_eligible", "set_engine", "engine_override",
           "resolve_engine"]

_MODES = ("auto", "eager", "kernel")
_FORCE: str | None = None


def set_engine(mode: str | None):
    """Pin the engine globally (tests, debugging); None restores "auto"."""
    global _FORCE
    if mode is not None and mode not in _MODES:
        raise ValueError(f"unknown engine {mode!r}")
    _FORCE = mode


@contextlib.contextmanager
def engine_override(mode: str | None):
    prev = _FORCE
    set_engine(mode)
    try:
        yield
    finally:
        set_engine(prev)


def kernel_eligible(model, Hx, Hy, apodization=None) -> bool:
    """Static eligibility of a (system, call) for K1 (the counterpart of
    ``pallas_eligible``): a supported surface stack and launch mode, field
    coordinates that are scalars or 1-D, and no apodization or a
    closed-form one."""
    if not kernel_apodization(apodization):
        return False
    if ndim(Hx) > 1 or ndim(Hy) > 1:
        return False
    return gen_eligible(model) and supports_model(model)


def resolve_engine(model, Hx, Hy, device, mode: str = "auto",
                   apodization=None) -> str:
    """The dispatch decision: "kernel" or "eager"."""
    if mode not in _MODES:
        raise ValueError(f"unknown engine {mode!r}")
    ok = kernel_eligible(model, Hx, Hy, apodization)
    if mode == "kernel":
        if not ok:
            raise ValueError("system/call not eligible for the K1 kernel")
        return "kernel"
    if mode == "eager":
        return "eager"
    return "kernel" if ok and torch.device(device).type == "cuda" else "eager"


def final_rays(model, params, Hx, Hy, wavelength, Px, Py, *,
               final_prop: bool = True, engine: str = "auto",
               apodization=None):
    """Final-surface ray state via the engine the mode selects.

    ``wavelength`` is a scalar (len(Px) rays per field) or a 1-D tensor of W
    wavelengths (W*F*len(Px) rays, wavelength-major, in both engines);
    ``apodization`` weighs the launch intensity."""
    mode = _FORCE or engine
    if resolve_engine(model, Hx, Hy, Px.device, mode,
                      apodization) == "kernel":
        return gen_trace_conic(model, params, Px, Py, wavelength, Hx=Hx,
                               Hy=Hy, final_prop=final_prop,
                               apodization=apodization)
    wl = torch.as_tensor(wavelength, dtype=Px.dtype, device=Px.device)
    if wl.ndim == 0:
        return real_trace.trace(model, params, Hx, Hy, wl, Px, Py,
                                final_prop=final_prop,
                                apodization=apodization)
    per_wl = [real_trace.trace(model, params, Hx, Hy, w, Px, Py,
                               final_prop=final_prop,
                               apodization=apodization) for w in wl]
    out = {f: torch.cat([getattr(r, f).reshape(-1) for r in per_wl])
           for f in per_wl[0].__dataclass_fields__ if f != "p"}
    if per_wl[0].p is not None:
        out["p"] = torch.cat([r.p.reshape(-1, 3, 3) for r in per_wl])
    return type(per_wl[0])(**out)
