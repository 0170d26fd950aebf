"""K3 in the port: the surface stack on given rays (counterpart of
``optiland_pr_tpu/kernels/pallas_trace.py::_pallas_call_2d`` and its entry
point ``pallas_trace_conic``).

Where K1 generates its rays from pupil samples and propagates them to the
image, K3 takes a ray bundle as it is (from ``trace.raygen.generate_rays``
or any other source), runs each surface of the stack (validity starting
true, the plain OPD sum), and returns the rays on the image surface, before
the image thickness, with NaN in the state of the rays lost on the way. The
surfaces are K1's: sub-slices (a), (b), (c) and (f), the gratings and
phase surfaces (``gen_trace.supports_model``), one wavelength per call.

The module holds
- ``trace_plain``: the plain PyTorch version, K1's per-surface body
  (``gen_trace._surface_plain``) on the given rays;
- ``trace_cuda``: the wrapper of the CUDA kernel ``csrc/trace.cu``, which
  runs K1's device surface step, with a launch counter like K1's;
- ``trace_conic``: the entry point. A CPU tensor takes the plain version, a
  CUDA tensor the kernel, with no fallback between the two. The kernel has
  no backward (nor has the Pallas kernel): a CUDA tensor that requires grad
  raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.rays import Rays
from ..system.model import OpticModel
from .gen_trace import (CONST_W, MAX_SURFACES, VARIANTS, SurfaceFlags,
                        _flag_words, _surface_plain, build_kernel,
                        acoef_width, model_flags, n_coefs,
                        pack_asphere_coeffs,
                        pack_surface_constants, supports_model, zernike_table)

__all__ = ["trace_plain", "trace_cuda", "trace_conic", "RAY_FIELDS"]

# the rows of the [8, n] ray table, in and out
RAY_FIELDS = ("x", "y", "z", "L", "M", "N", "intensity", "opd")


def trace_plain(consts, acoef, rays, flags):
    """The plain K3 on the [8, n] ray table ``rays`` (``RAY_FIELDS``):
    ``consts`` [S, 32] one wavelength's constant rows, ``acoef`` [S, C] the
    sag coefficients, ``flags`` one ``SurfaceFlags`` per surface. Every
    operation is K1's plain version's; returns [8, n] with NaN in the state
    (not the intensity) of the lost rays."""
    if len(flags) != consts.shape[0]:
        raise ValueError(f"{len(flags)} flags for {consts.shape[0]} surfaces")
    x, y, z, L, M, N, inten, opd = rays
    state = (x, y, z, L, M, N, inten, opd, torch.zeros_like(x),
             torch.ones_like(x, dtype=torch.bool))
    for k, flag in enumerate(flags):
        flag = SurfaceFlags(*flag)

        def c(j, k=k):
            return consts[k, j]
        coefs = [acoef[k, i] for i in range(n_coefs(flag.gkind, flag.nu,
                                                    flag.nv))]
        state = _surface_plain(flag, c, coefs, state, 1.0, "plain")
    x, y, z, L, M, N, inten, opd, _, valid = state

    def m(v):
        return torch.where(valid, v, torch.nan)
    return torch.stack([m(x), m(y), m(z), m(L), m(M), m(N), inten, m(opd)])


def trace_cuda(consts, acoef, rays, flags):
    """Launch the CUDA K3 on the current stream; returns [8, n] float32.
    Raises on anything the kernel does not take: contiguous float32 CUDA
    tensors on one device, none requiring grad, consts [S, 32], acoef [S, C]
    with C at least every surface's terms, rays [8, n]."""
    dev = rays.device
    for name, t in (("consts", consts), ("acoef", acoef), ("rays", rays)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda" \
                or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.requires_grad:
            raise ValueError(f"K3 has no backward: {name} requires grad")
    S = consts.shape[0]
    if (consts.ndim != 2 or consts.shape[1] != CONST_W or acoef.ndim != 2
            or acoef.shape[0] != S or rays.ndim != 2 or rays.shape[0] != 8):
        raise ValueError("bad table shapes: consts [S, 32], acoef [S, C], "
                         "rays [8, n]")
    if len(flags) != S or not 1 <= S <= MAX_SURFACES:
        raise ValueError(f"need 1..{MAX_SURFACES} surfaces with one flag "
                         f"each, got {S} surfaces and {len(flags)} flags")
    flags = [SurfaceFlags(*f) for f in flags]
    if any(acoef_width(f.gkind, f.nu, f.nv) > acoef.shape[1]
           for f in flags):
        raise ValueError("acoef has fewer columns than a surface's terms")
    n = rays.shape[1]
    out = torch.empty_like(rays)
    if n == 0:
        return out
    lib = build_kernel("trace")
    words = _flag_words(flags)
    words = (ctypes.c_int32 * S)(*words)
    variant = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        err = lib.trace_launch(consts.data_ptr(), acoef.data_ptr(),
                               zernike_table(dev).data_ptr(),
                               rays.data_ptr(), out.data_ptr(),
                               ctypes.addressof(words), S, acoef.shape[1], n,
                               torch.cuda.current_stream(dev).cuda_stream,
                               ctypes.byref(variant))
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: CUDA error {err}")
    trace_cuda.launches += 1
    trace_cuda.launches_by_variant[VARIANTS[variant.value]] += 1
    return out


trace_cuda.launches = 0
trace_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def trace_conic(model: OpticModel, params, rays: Rays, wavelength) -> Rays:
    """Trace the bundle ``rays`` through the surfaces of the system at the
    scalar ``wavelength``; the counterpart of ``pallas_trace_conic``. Returns
    the rays on the image surface (before the image thickness), float32,
    with NaN in the state of lost rays and the input's wavelength.

    K3 runs on the device of ``rays.x``: the plain version on the CPU, the
    CUDA kernel on the card."""
    if not supports_model(model):
        raise ValueError("the system has a surface K3 does not cover "
                         "(gen_trace.supports_model)")
    if torch.as_tensor(wavelength).ndim != 0:
        raise ValueError("K3 traces one wavelength per call")
    dev = rays.x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"K3 has no version for device {dev}")
    shape = rays.x.shape
    table = torch.stack([torch.broadcast_to(
        torch.as_tensor(getattr(rays, k)), shape).reshape(-1)
        .to(dev, torch.float32) for k in RAY_FIELDS]).contiguous()
    consts = pack_surface_constants(model, params, wavelength).to(dev)
    acoef = pack_asphere_coeffs(model, params).to(dev).contiguous()
    flags = model_flags(model, params)
    if dev.type == "cpu":
        out = trace_plain(consts, acoef, table, flags)
    else:
        out = trace_cuda(consts.contiguous(), acoef, table, flags)
    return rays.replace(**{k: v.reshape(shape)
                           for k, v in zip(RAY_FIELDS, out)})
