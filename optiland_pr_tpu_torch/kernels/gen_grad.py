"""K2 in the port: the backward of K1 for the sub-slices K1 covers, (a), (b),
(c), (d), (e), (f) and the OPD modes of (g) (counterpart of
``optiland_pr_tpu/kernels/pallas_grad.py``: ``_pallas_gen_bwd_2d`` and the
``diff_gen_trace`` custom_vjp).

The module holds
- ``gen_trace_bwd_plain``: the plain version. It recomputes
  ``gen_trace_plain`` under autograd and returns ``torch.autograd.grad`` for
  the given cotangents;
- ``gen_trace_bwd_cuda``: the wrapper of the hand-written CUDA kernel
  ``csrc/gen_grad.cu``, built with nvcc at first use (one library per OPD
  mode, and per mode one of the polarized instances; the systems with a
  grating or phase surface take libraries of their own, ``grad_lib``) and
  bound with ctypes;
- ``GenTrace``: the ``torch.autograd.Function`` over K1. Its forward is K1
  (the CUDA kernel on CUDA tensors, the plain version on CPU tensors), its
  backward K2 on the same device. A CUDA tensor never falls back to a plain
  version.

Gradient semantics are those of the JAX custom_vjp: the cotangents of lost
rays' x, y, z, L, M, N and OPD are zeroed by the transpose of the final NaN
step (a NaN cotangent from an unmasked consumer becomes 0); the intensity is
never masked, so its cotangent flows through lost rays too.
"""
from __future__ import annotations

import ctypes

import torch

from .gen_trace import (CONST_W, GEN_W, OPD_MODES, VARIANTS, build_kernel,
                        check_tables, gen_trace_cuda, gen_trace_plain,
                        grad_lib, has_doe, polar_words, zernike_table)

__all__ = ["gen_trace_bwd_plain", "gen_trace_bwd_cuda", "GenTrace"]


def gen_trace_bwd_plain(gen, consts, acoef, Px, Py, cot, flags,
                        final_prop: bool, opd_mode: str = "plain",
                        polar=None):
    """(dgen [F, 16], dconsts [W, S, 32], dacoef [S, C], dPx [n], dPy [n])
    for the cotangents ``cot`` [8, W, F, n] of K1's outputs, by autograd
    through the plain version in the OPD mode ``opd_mode`` with the launch
    polarization ``polar`` (a ``PolarLaunch`` or None)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (gen, consts, acoef, Px, Py)]
        out = gen_trace_plain(*leaves, flags, final_prop, opd_mode, polar)
        grads = torch.autograd.grad(out, leaves, cot, allow_unused=True)
    return tuple(torch.zeros_like(t) if d is None else d
                 for t, d in zip(leaves, grads))


def gen_trace_bwd_cuda(gen, consts, acoef, Px, Py, cot, flags,
                       final_prop: bool, pupil_grad: bool = True,
                       opd_mode: str = "plain", polar=None):
    """Launch the CUDA K2 on the current stream; returns what
    ``gen_trace_bwd_plain`` returns, with dPx/dPy None unless
    ``pupil_grad``. Raises on anything the kernel does not take."""
    (W, S, F, n, C), words, mode = check_tables(gen, consts, acoef, Px, Py,
                                                flags, opd_mode, cot=cot)
    if tuple(cot.shape) != (8, W, F, n) or n < 1:
        raise ValueError("cot must be [8, W, F, n] with n >= 1")
    dev = Px.device
    doe = has_doe(flags)
    lib = build_kernel(grad_lib(opd_mode, polar, doe))
    words = (ctypes.c_int32 * S)(*words)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    part = empty(lib.gen_grad_partials_size(ctypes.addressof(words), S, F, W,
                                            n, mode))
    dgen, dconsts, dacoef = empty(F, GEN_W), empty(W, S, CONST_W), \
        empty(*acoef.shape)
    if pupil_grad:
        dpx_wf, dpy_wf, dpx, dpy = empty(W, F, n), empty(W, F, n), \
            empty(n), empty(n)
        ptrs = [t.data_ptr() for t in (dpx_wf, dpy_wf)]
        outs = [t.data_ptr() for t in (dpx, dpy)]
    else:
        dpx = dpy = None
        ptrs = outs = [None, None]
    stream = torch.cuda.current_stream(dev).cuda_stream
    variant = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        err = lib.gen_grad_launch(
            gen.data_ptr(), consts.data_ptr(), acoef.data_ptr(),
            zernike_table(dev).data_ptr(), Px.data_ptr(), Py.data_ptr(),
            cot.data_ptr(), part.data_ptr(),
            *ptrs, dgen.data_ptr(), dconsts.data_ptr(), dacoef.data_ptr(),
            *outs, ctypes.addressof(words), S, F, W, C, n,
            int(bool(final_prop)), mode, polar_words(polar), stream,
            ctypes.byref(variant))
    if err != 0:
        raise RuntimeError(f"gen_grad kernel launch failed: CUDA error {err}")
    gen_trace_bwd_cuda.launches += 1
    gen_trace_bwd_cuda.launches_by_mode[opd_mode] += 1
    gen_trace_bwd_cuda.launches_by_variant[VARIANTS[variant.value]] += 1
    gen_trace_bwd_cuda.launches_polarized += polar is not None
    gen_trace_bwd_cuda.launches_doe += doe
    return dgen, dconsts, dacoef, dpx, dpy


gen_trace_bwd_cuda.launches = 0
gen_trace_bwd_cuda.launches_by_mode = dict.fromkeys(OPD_MODES, 0)
gen_trace_bwd_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
gen_trace_bwd_cuda.launches_polarized = 0
gen_trace_bwd_cuda.launches_doe = 0


class GenTrace(torch.autograd.Function):
    """K1 with K2 as its backward: ``GenTrace.apply(gen, consts, acoef, Px,
    Py, flags, final_prop, opd_mode, polar)`` returns K1's [8, W, F, n]
    outputs (``polar`` a ``PolarLaunch`` or None)."""

    @staticmethod
    def forward(ctx, gen, consts, acoef, Px, Py, flags, final_prop,
                opd_mode="plain", polar=None):
        ctx.save_for_backward(gen, consts, acoef, Px, Py)
        ctx.flags = flags
        ctx.final_prop = final_prop
        ctx.opd_mode = opd_mode
        ctx.polar = polar
        if Px.device.type == "cuda":
            return gen_trace_cuda(gen, consts, acoef, Px, Py, flags,
                                  final_prop, opd_mode, polar)
        return gen_trace_plain(gen, consts, acoef, Px, Py, flags, final_prop,
                               opd_mode, polar)

    @staticmethod
    def backward(ctx, cot):
        gen, consts, acoef, Px, Py = ctx.saved_tensors
        need = ctx.needs_input_grad
        cot = cot.contiguous()
        if cot.device.type == "cuda":
            grads = gen_trace_bwd_cuda(gen, consts, acoef, Px, Py, cot,
                                       ctx.flags, ctx.final_prop,
                                       pupil_grad=need[3] or need[4],
                                       opd_mode=ctx.opd_mode,
                                       polar=ctx.polar)
        else:
            grads = gen_trace_bwd_plain(gen, consts, acoef, Px, Py, cot,
                                        ctx.flags, ctx.final_prop,
                                        ctx.opd_mode, ctx.polar)
        return tuple(g if need[i] else None
                     for i, g in enumerate(grads)) + (None,) * 4
