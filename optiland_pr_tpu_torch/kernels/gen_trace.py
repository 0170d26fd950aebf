"""K1 in the port: fused ray generation + surface stack + image propagation
(counterpart of ``optiland_pr_tpu/kernels/pallas_trace.py::_pallas_gen_trace_2d``
and its entry point ``pallas_gen_trace_conic``), sub-slice (a): conic and plane
surfaces that refract or reflect, with absorption in the pre-material.

The module holds
- the host plumbing: ``supports_model``, ``gen_eligible``, ``model_flags``,
  ``pack_surface_constants``, ``pack_asphere_coeffs`` and ``gen_tables``,
  with the JAX package's table layout (``pallas_trace.py:37-46``);
- ``gen_trace_plain``: the plain PyTorch version of the kernel on the packed
  tables, in the kernel's operation order;
- ``gen_trace_cuda``: the wrapper of the hand-written CUDA kernel
  ``csrc/gen_trace.cu``, built with nvcc at first use and bound with ctypes;
- ``gen_trace_conic``, the counterpart of ``pallas_gen_trace_conic``: a CPU
  tensor takes the plain version, a CUDA tensor the kernel, and nothing
  falls back.

Outputs are [8, W, F, n] float32 (x, y, z, L, M, N, intensity, opd) in
(wavelength, field, pupil) order.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..core.rays import Rays
from ..system.model import OpticModel, positions_from_params

__all__ = ["supports_model", "gen_eligible", "model_flags",
           "pack_surface_constants", "pack_asphere_coeffs", "gen_tables",
           "gen_trace_plain", "gen_trace_cuda", "gen_trace_conic",
           "build_kernel"]

CONST_W = 32       # per-surface constant row width
GEN_W = 16         # per-field launch row width
MAX_SURFACES = 64  # the kernel's static flag table (csrc/gen_trace.cu)
_EPS = 1e-14

FLAG_PLANE, FLAG_REFL, FLAG_ABSORB = 1, 2, 4

_SRC = Path(__file__).resolve().parent / "csrc" / "gen_trace.cu"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"


# ---------------------------------------------------------------------------
# eligibility and static flags
# ---------------------------------------------------------------------------

def supports_model(model: OpticModel) -> bool:
    """True if every inner surface is in sub-slice (a): a conic or plane
    surface (refracting or reflecting), untilted, without a physical
    aperture, and the stack fits the kernel's flag table."""
    if model.num_surfaces - 1 > MAX_SURFACES:
        return False
    return all(spec.geometry.kind in ("standard", "plane")
               and spec.aperture is None and not spec.has_tilt_decenter
               for spec in model.surfaces[1:])


def gen_eligible(model: OpticModel) -> bool:
    """Launch modes the fused generation covers: origin x0 = Px*A + xf aimed
    at x1 = Px*B on the entrance-pupil plane (angle fields, finite-object
    object-height fields, paraxial-image-height fields)."""
    if model.field_type == "angle":
        return True
    if model.field_type == "object_height":
        return not model._object_infinite
    return model.field_type == "paraxial_image_height"


def model_flags(model: OpticModel, params=None) -> tuple:
    """Static (is_plane, is_reflective, absorbing) per inner surface, read
    from host-side hints only (``Geometry.radius_is_inf``, stamped by
    ``Optic.build``); a geometry without the hint is read from ``params``."""
    flags = []
    for k in range(1, model.num_surfaces):
        spec = model.surfaces[k]
        is_plane = spec.geometry.radius_is_inf
        if is_plane is None:
            is_plane = bool(torch.isinf(
                params["surfaces"][k]["geom"]["radius"]).item())
        pre = model.surfaces[k - 1]
        absorbing = model.surfaces[pre.material_src].material.absorbing
        flags.append((bool(is_plane), bool(spec.is_reflective),
                      bool(absorbing)))
    return tuple(flags)


def _flag_words(flags) -> list:
    return [(FLAG_PLANE if p else 0) | (FLAG_REFL if r else 0)
            | (FLAG_ABSORB if a else 0) for p, r, a in flags]


# ---------------------------------------------------------------------------
# table packing
# ---------------------------------------------------------------------------

def _pack_surface(model: OpticModel, params, k: int, wls, pos):
    """[W, 32] constant rows of surface k for the wavelengths ``wls`` [W]."""
    spec = model.surfaces[k]
    sp = params["surfaces"][k]
    ref = sp["thickness"]
    W = wls.shape[0]

    def col(v):
        return torch.as_tensor(v, dtype=ref.dtype, device=ref.device
                               ).reshape(-1).expand(W)

    radius = sp["geom"]["radius"]
    conic = sp["geom"]["conic"]
    is_plane = torch.isinf(radius)
    radius_inv = torch.where(is_plane, 0.0, 1.0 / radius)
    # column 28: the low word of 1/R against its float32-rounded high word
    # (the two-float curvature of the coord_split mode); float32 parameters
    # make the f64 product below exact
    rih = radius_inv.to(torch.float32).to(torch.float64)
    rsafe = torch.where(is_plane, 1.0, radius).to(torch.float64)
    radius_inv_lo = torch.where(is_plane, 0.0, (1.0 - rih * rsafe) / rsafe)

    pre = model.surfaces[k - 1]
    mat1 = model.surfaces[pre.material_src].material
    mp1 = params["surfaces"][pre.material_src]["material"]
    n1 = mat1.n(mp1, wls)
    if spec.is_reflective:
        n2 = n1
    else:
        n2 = model.surfaces[spec.material_src].material.n(
            params["surfaces"][spec.material_src]["material"], wls)
    alpha = 4.0 * math.pi * mat1.k(mp1, wls) / wls if mat1.absorbing else 0.0

    # signed vertex gap (the split-OPD modes read it)
    dz_gap = pos[k] - pos[k - 1]
    dz_gap = torch.where(torch.isfinite(dz_gap), dz_gap, 0.0)
    # columns 8-19 (rotation, translation) stay zero and 20-23 hold the
    # no-aperture annulus (0, inf) with no offset: sub-slice (a) surfaces
    # are untilted and unapertured; 6 (coating factor) is 1
    cols = ([radius_inv, conic, pos[k], n1, n2, alpha, 1.0, wls]
            + [0.0] * 12
            + [0.0, math.inf, 0.0, 0.0, 0.0, 0.0, 0.0, dz_gap, radius_inv_lo,
               0.0, 0.0, 0.0])
    return torch.stack([col(v) for v in cols], dim=-1)


def pack_surface_constants(model: OpticModel, params, wavelength):
    """float32 [S-1, 32] constants for a scalar wavelength, or [W, S-1, 32]
    for a 1-D tensor of W wavelengths (``pallas_trace.py::_pack_rows``), for
    a system ``supports_model`` accepts."""
    if not supports_model(model):
        raise NotImplementedError("only sub-slice (a) systems are packed")
    ref = params["surfaces"][0]["thickness"]
    wl = torch.as_tensor(wavelength, dtype=ref.dtype, device=ref.device)
    wls = torch.atleast_1d(wl)
    pos = positions_from_params(params)
    rows = torch.stack([_pack_surface(model, params, k, wls, pos)
                        for k in range(1, model.num_surfaces)], dim=1)
    rows = rows.to(torch.float32)
    return rows[0] if wl.ndim == 0 else rows


def pack_asphere_coeffs(model: OpticModel, params):
    """float32 [S-1, 8] geometry coefficients. Conic and plane surfaces carry
    none, so for sub-slice (a) this is the zero table the kernel interface
    keeps for the freeform sub-slices."""
    ref = params["surfaces"][0]["thickness"]
    return torch.zeros((model.num_surfaces - 1, 8), dtype=torch.float32,
                       device=ref.device)


def gen_tables(model: OpticModel, params, wavelength, Hx=0.0, Hy=0.0):
    """(gen [F, 16], consts [W, S-1, 32], acoef [S-1, 8]), all float32,
    for the fields (Hx, Hy) (scalars or 1-D) and the wavelength(s).

    Vignetting folds into the half-EPD terms; the field coordinates are
    rounded to float32 first, as the JAX package does."""
    from ..trace.paraxial import Paraxial
    from ..trace.raygen import _ray_origins, vig_factor

    ref = params["surfaces"][0]["thickness"]
    dt, dev = ref.dtype, ref.device
    wls = torch.atleast_1d(torch.as_tensor(wavelength, dtype=dt, device=dev))
    consts = pack_surface_constants(model, params, wls)

    par = Paraxial(model, params)
    EPL = par.EPL()
    EPD = par.EPD()
    Hxa = torch.atleast_1d(torch.as_tensor(Hx, dtype=torch.float32))
    Hya = torch.atleast_1d(torch.as_tensor(Hy, dtype=torch.float32))
    Hxa, Hya = torch.broadcast_tensors(Hxa.to(dev, dt), Hya.to(dev, dt))
    zero = torch.zeros((), dtype=dt, device=dev)
    rows = []
    for f in range(Hxa.shape[0]):
        hx, hy = Hxa[f], Hya[f]
        vxf, vyf = vig_factor(model, params, hx, hy)
        vx = 1.0 - vxf.reshape(())
        vy = 1.0 - vyf.reshape(())
        # the origin is Px*A + xf, so the pupil-centre sample isolates xf
        z1 = torch.zeros((1,), dtype=dt, device=dev)
        x0c, y0c, z0c = _ray_origins(model, params, par, hx, hy, z1, z1,
                                     vx, vy)
        if model._object_infinite:
            ax, ay = EPD / 2 * vx, EPD / 2 * vy
        else:
            ax = ay = zero
        t_img = params["surfaces"][-1]["thickness"].reshape(())
        rows.append(torch.stack(
            [ax.reshape(()), ay.reshape(()), x0c[0], y0c[0], z0c[0],
             EPL.reshape(()), t_img, zero, (EPD / 2 * vx).reshape(()),
             (EPD / 2 * vy).reshape(())] + [zero] * 6))
    gen = torch.stack(rows).to(torch.float32)
    return gen, consts, pack_asphere_coeffs(model, params)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _eps_guard(v):
    """|v| > eps ? v : (v >= 0 ? eps : -eps), eps in v's dtype."""
    return torch.where(torch.abs(v) > _EPS, v,
                       torch.where(v >= 0, v.new_tensor(_EPS),
                                   v.new_tensor(-_EPS)))


def gen_trace_plain(gen, consts, acoef, Px, Py, flags, final_prop: bool):
    """Plain PyTorch K1 on the packed tables: every elementwise operation of
    ``csrc/gen_trace.cu`` in the same order, broadcast over [W, F, n].
    ``acoef`` is unused by sub-slice (a). Differentiable by autograd."""
    W, S = consts.shape[0], consts.shape[1]
    F, n = gen.shape[0], Px.shape[0]
    if len(flags) != S:
        raise ValueError(f"{len(flags)} flags for {S} surfaces")

    def g(j):                               # per-field constant, [1, F, 1]
        return gen[:, j].reshape(1, F, 1)

    px = Px.reshape(1, 1, n)
    py = Py.reshape(1, 1, n)
    x = (px * g(0) + g(2)).expand(W, F, n)
    y = (py * g(1) + g(3)).expand(W, F, n)
    z = g(4).expand(W, F, n)
    dxr = px * g(8) - x
    dyr = py * g(9) - y
    dzr = g(5) - z
    inv_mag = torch.reciprocal(torch.sqrt(dxr * dxr + dyr * dyr + dzr * dzr))
    L, M, N = dxr * inv_mag, dyr * inv_mag, dzr * inv_mag
    inten = torch.ones_like(x)
    opd = torch.zeros_like(x)
    valid = torch.ones_like(x, dtype=torch.bool)

    for k, (is_plane, is_refl, absorbing) in enumerate(flags):
        def c(j):                           # per-wavelength constant, [W, 1, 1]
            return consts[:, k, j].reshape(W, 1, 1)
        ri, conic, pos_z, n1, n2, alpha = (c(j) for j in range(6))
        z = z - pos_z
        if is_plane:
            t = -z / N
        else:
            t0 = -z / N
            x0 = x + t0 * L
            y0 = y + t0 * M
            a = (conic * N * N + 1.0) * ri
            bh = (L * x0 + M * y0) * ri - N
            cc = (x0 * x0 + y0 * y0) * ri
            disc = bh * bh - a * cc
            ok = disc >= 0
            sq = torch.sqrt(torch.where(ok, disc, 1.0))
            q = -(bh + torch.where(bh >= 0, sq, -sq))   # sign(0) := +1
            t_far = q / _eps_guard(a)
            t_near = cc / _eps_guard(q)
            tq = torch.where(torch.abs(t_near) <= torch.abs(t_far),
                             t_near, t_far)
            t = t0 + torch.where(ok, tq, 0.0)
            valid = valid & ok
        x = x + t * L
        y = y + t * M
        z = z + t * N
        opd = opd + torch.abs(t * n1)
        if absorbing:
            inten = inten * torch.exp(-alpha * t * 1e3)

        if is_plane and is_refl:
            N = -N
        elif is_plane:
            u = n1 / n2
            disc_r = 1.0 - u * u * (1.0 - N * N)
            ok_r = disc_r >= 0
            root_r = torch.sqrt(torch.where(ok_r, disc_r, 1.0))
            valid = valid & ok_r
            L, M, N = u * L, u * M, torch.sign(N) * root_r
        else:
            r2 = x * x + y * y
            arg = 1.0 - (1.0 + conic) * ri * ri * r2
            inv_root = torch.reciprocal(torch.sqrt(
                torch.where(arg > _EPS, arg, 1.0)))
            dfdx = x * ri * inv_root
            dfdy = y * ri * inv_root
            inv_n = torch.reciprocal(torch.sqrt(dfdx * dfdx + dfdy * dfdy
                                                + 1.0))
            nx, ny, nz = dfdx * inv_n, dfdy * inv_n, -inv_n
            dot = L * nx + M * ny + N * nz
            if is_refl:
                two_dot = 2.0 * dot
                L, M, N = L - two_dot * nx, M - two_dot * ny, N - two_dot * nz
            else:
                u = n1 / n2
                disc_r = 1.0 - u * u * (1.0 - dot * dot)
                ok_r = disc_r >= 0
                root_r = torch.sqrt(torch.where(ok_r, disc_r, 1.0))
                w = torch.sign(dot) * root_r - u * dot
                L, M, N = u * L + nx * w, u * M + ny * w, u * N + nz * w
                valid = valid & ok_r
        z = z + pos_z

    if final_prop:
        t_img = g(6)
        x = x + t_img * L
        y = y + t_img * M
        z = z + t_img * N

    def m(v):
        return torch.where(valid, v, torch.nan)
    return torch.stack([m(x), m(y), m(z), m(L), m(M), m(N), inten, m(opd)])


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(str(Path(os.environ[env]) / "bin" / "nvcc"))
    candidates.append(_DEFAULT_NVCC)
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found: the K1 kernel (kernels/csrc/gen_trace.cu) is built "
        "from source at first use. Install the CUDA toolkit, or put nvcc on "
        "PATH or under CUDA_HOME/bin.")


@functools.lru_cache(maxsize=1)
def build_kernel():
    """Compile ``csrc/gen_trace.cu`` for sm_90a into a shared library under
    ``kernels/_build/`` (keyed by a hash of the source), load it with ctypes
    and declare its signature."""
    src = _SRC.read_bytes()
    key = hashlib.sha256(src).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"gen_trace_{key}.so"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp), str(_SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.gen_trace_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def gen_trace_cuda(gen, consts, acoef, Px, Py, flags, final_prop: bool):
    """Launch the CUDA K1 on the current stream; returns [8, W, F, n]
    float32. Raises on anything the kernel does not take."""
    dev = Px.device
    for name, t in (("gen", gen), ("consts", consts), ("Px", Px),
                    ("Py", Py)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    W, S = consts.shape[0], consts.shape[1]
    F, n = gen.shape[0], Px.shape[0]
    if (consts.shape[2] != CONST_W or gen.shape[1] != GEN_W
            or Px.shape != Py.shape or Px.ndim != 1):
        raise ValueError("bad table shapes: gen [F, 16], consts [W, S, 32], "
                         "Px/Py [n]")
    if len(flags) != S or not 1 <= S <= MAX_SURFACES:
        raise ValueError(f"need 1..{MAX_SURFACES} surfaces with one flag "
                         f"each, got {S} surfaces and {len(flags)} flags")
    if not (1 <= F <= 65535 and 1 <= W <= 65535):
        raise ValueError("F and W must be in 1..65535")
    out = torch.empty((8, W, F, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = build_kernel()
    words = (ctypes.c_int32 * S)(*_flag_words(flags))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.gen_trace_launch(gen.data_ptr(), consts.data_ptr(),
                                   Px.data_ptr(), Py.data_ptr(),
                                   out.data_ptr(), ctypes.addressof(words),
                                   S, F, W, n, int(bool(final_prop)), stream)
    if err != 0:
        raise RuntimeError(f"gen_trace kernel launch failed: CUDA error {err}")
    gen_trace_cuda.launches += 1
    return out


gen_trace_cuda.launches = 0


def gen_trace_conic(model: OpticModel, params, Px, Py, wavelength,
                    Hx=0.0, Hy=0.0, final_prop: bool = False) -> Rays:
    """Fused generation + trace of the pupil samples (Px, Py) for the
    wavelength(s) and field point(s) given; the counterpart of
    ``pallas_gen_trace_conic``.

    K1 runs on the device of ``Px``: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors, with no fallback between the two.

    A scalar wavelength and scalar field return ``n`` rays; a field vector
    F*n rays (field-major); a wavelength vector W*F*n rays in (wavelength,
    field, pupil) order. Outputs are float32."""
    if not (supports_model(model) and gen_eligible(model)):
        raise ValueError("system/call not eligible for the K1 kernel")
    px = torch.as_tensor(Px, dtype=torch.float32).contiguous()
    py = torch.as_tensor(Py, dtype=torch.float32).contiguous()
    if px.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K1 has no version for device {px.device}")
    flags = model_flags(model, params)
    gen, consts, acoef = gen_tables(model, params, wavelength, Hx, Hy)
    if px.device.type == "cpu":
        out = gen_trace_plain(gen, consts, acoef, px, py, flags, final_prop)
    elif any(t.requires_grad for t in (gen, consts, px, py)):
        raise NotImplementedError(
            "gradients through K1 on the card need the backward kernel K2 "
            "(optiland_pr_tpu/kernels/pallas_grad.py::_pallas_gen_bwd_2d), "
            "which is not ported yet; use engine='eager'")
    else:
        out = gen_trace_cuda(gen, consts, acoef, px, py, flags, final_prop)
    field_vec = ndim(Hx) == 1 or ndim(Hy) == 1
    return rays_from_outputs(out, consts[:, 0, 7], ndim(wavelength) == 0,
                             field_vec)


def ndim(v) -> int:
    """Number of dimensions of a tensor, array, sequence or scalar."""
    return v.ndim if isinstance(v, torch.Tensor) else int(np.ndim(v))


def rays_from_outputs(out, wls, scalar_wl: bool, field_vec: bool) -> Rays:
    """``Rays`` from the [8, W, F, n] outputs, with the JAX package's
    squeezing of scalar wavelength and field axes."""
    _, W, F, n = out.shape
    wl_col = wls.to(out.dtype).reshape(W, 1, 1).expand(W, F, n)
    arrs = list(out) + [wl_col]
    if scalar_wl and not field_vec:
        arrs = [a[0, 0] for a in arrs]
    elif scalar_wl:
        arrs = [a[0].reshape(-1) for a in arrs]
    else:
        arrs = [a.reshape(-1) for a in arrs]
    x, y, z, L, M, N, inten, opd, wl = arrs
    return Rays(x=x, y=y, z=z, L=L, M=M, N=N, intensity=inten,
                wavelength=wl, opd=opd)
