"""Polarization: Jones calculus on 3x3 per-ray matrices
(port of ``optiland_pr_tpu/core/polarization.py``).

- ``PolarizationState``: the launch state, a Jones vector (Ex, Ey) with a
  phase on each component;
- ``fresnel_jones``: the s/p Fresnel amplitude coefficients of an interface
  as per-ray diagonal 3x3 Jones matrices;
- ``polarization_update_matrix`` / ``apply_polarization_update``: a surface's
  3x3 matrix O_out J O_in (into the s/p basis of the interaction plane, the
  Jones matrix, back out) and its composition onto the running per-ray chain
  (the ``p`` field of ``core/rays.Rays``);
- ``update_intensity``: the final intensity from the chain and the launch
  state;
- the fixed polarizer, diattenuator and retarder elements.

Everything runs on torch complex64 (float32 rays) or complex128 (float64
rays). The batched 3x3 products are ordinary ``torch.matmul`` calls: TF32
is off for matmul by default (``torch.backends.cuda.matmul.allow_tf32``), so
on the card they run in full float32, and nothing here turns it on. The JAX
package's ``precision="highest"`` has no counterpart: it exists for the
TPU's bfloat16 matrix unit.
"""
from __future__ import annotations

import cmath
import dataclasses
import math

import torch

__all__ = ["PolarizationState", "fresnel_jones", "polarization_update_matrix",
           "apply_polarization_update", "update_intensity",
           "jones_polarizer_h", "jones_polarizer_v", "jones_polarizer_l45",
           "jones_polarizer_l135", "jones_polarizer_rcp",
           "jones_polarizer_lcp",
           "jones_linear_diattenuator", "jones_linear_retarder",
           "jones_quarter_wave", "jones_half_wave"]


@dataclasses.dataclass(frozen=True)
class PolarizationState:
    """Jones-vector launch state: amplitudes Ex, Ey and their phases
    (radians); ``is_polarized=False`` is the unpolarized average."""
    is_polarized: bool = False
    Ex: float = 1.0
    Ey: float = 0.0
    phase_x: float = 0.0
    phase_y: float = 0.0


def _complex_of(dtype) -> torch.dtype:
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def fresnel_jones(n1, n2, aoi, reflect: bool):
    """Per-ray 3x3 diagonal Jones matrices [..., 3, 3] of an interface from
    n1 into n2 at the angles of incidence ``aoi``: the s and p amplitude
    coefficients and 1 (transmission), or (r_s, -r_p, -1) (reflection). The
    root is complex, so total internal reflection gives |r| = 1."""
    cos_i = torch.cos(aoi)
    n = n2 / n1
    root = torch.sqrt((n**2 - torch.sin(aoi) ** 2).to(
        _complex_of(cos_i.dtype)))
    if reflect:
        s = (cos_i - root) / (cos_i + root)
        p = (n**2 * cos_i - root) / (n**2 * cos_i + root)
        d = torch.stack([s, -p, -torch.ones_like(s)], dim=-1)
    else:
        s = 2 * cos_i / (cos_i + root)
        p = 2 * n * cos_i / (n**2 * cos_i + root)
        d = torch.stack([s, p, torch.ones_like(s)], dim=-1)
    return torch.diag_embed(d)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def polarization_update_matrix(L0, M0, N0, L1, M1, N1, jones=None,
                               normal=None):
    """A surface's polarization matrix p = O_out J O_in [..., 3, 3]: the
    rows of O_in are s, p0 = k0 x s and k0, the columns of O_out s,
    p1 = k1 x s and k1, for the directions k0 before and k1 after the
    interaction. ``jones`` is the interface's Jones matrix (None: the
    identity). ``normal``: the unit surface normal (nx, ny, nz); then
    s ~ k0 x n, which points where k0 x k1 does (k1 lies in span{k0, n})
    without its cancellation near normal incidence. Below |s| = 1e-6
    (float32) or 1e-12 (float64), at normal incidence, s falls back to
    k0 x (1, 0, 0)."""
    k0 = torch.stack([L0, M0, N0], dim=-1)
    k1 = torch.stack([L1, M1, N1], dim=-1)
    if normal is not None:
        nvec = torch.stack(torch.broadcast_tensors(*[
            torch.as_tensor(v, dtype=k0.dtype, device=k0.device)
            for v in normal]), dim=-1)
        s = _cross(k0, nvec.expand(k0.shape))
    else:
        s = _cross(k0, k1)
    mag = torch.linalg.norm(s, dim=-1)
    eps = 1e-6 if k0.dtype == torch.float32 else 1e-12
    xaxis = torch.tensor([1.0, 0.0, 0.0], dtype=k0.dtype,
                         device=k0.device).expand(k0.shape)
    s = torch.where((mag < eps)[..., None], _cross(k0, xaxis), s)
    s = s / torch.linalg.norm(s, dim=-1)[..., None]
    p0 = _cross(k0, s)
    p1 = _cross(k1, s)
    o_in = torch.stack((s, p0, k0), dim=-2)     # rows: s, p, k
    o_out = torch.stack((s, p1, k1), dim=-1)    # columns: s, p, k
    if jones is None:
        return torch.matmul(o_out, o_in)
    return torch.matmul(o_out.to(jones.dtype),
                        torch.matmul(jones, o_in.to(jones.dtype)))


def apply_polarization_update(p_chain, L0, M0, N0, L1, M1, N1, jones=None,
                              normal=None):
    """Compose this surface's polarization matrix onto the running chain,
    in the surface matrix's dtype: a complex chain meets a real (bare)
    surface as its real part, as the JAX package's cast does (below total
    internal reflection every Fresnel coefficient is real)."""
    p_surf = polarization_update_matrix(L0, M0, N0, L1, M1, N1, jones,
                                        normal=normal)
    if p_chain.is_complex() and not p_surf.is_complex():
        p_chain = p_chain.real
    return torch.matmul(p_surf, p_chain.to(p_surf.dtype))


def _initial_field(state: PolarizationState, L0, M0, N0, dtype):
    """The launch rays' 3-D E-field [..., 3] of ``dtype`` (complex): the
    basis p = k x (1, 0, 0) / |.|, s = p x k, and E = Ex e^(i phase_x) s +
    Ey e^(i phase_y) p."""
    k = torch.stack([L0, M0, N0], dim=-1)
    x = torch.tensor([1.0, 0.0, 0.0], dtype=k.dtype,
                     device=k.device).expand(k.shape)
    p = _cross(k, x)
    p = p / torch.linalg.norm(p, dim=-1)[..., None]
    s = _cross(p, k)
    return (state.Ex * cmath.exp(1j * state.phase_x) * s.to(dtype)
            + state.Ey * cmath.exp(1j * state.phase_y) * p.to(dtype))


def update_intensity(p_chain, state: PolarizationState | None, i0, L0, M0,
                     N0):
    """Final intensity from the accumulated chain [..., 3, 3] and the launch
    directions: sum |p E0|^2 for a polarized state, else the average of the
    two linear states times the launch intensity ``i0``. A polarized state's
    intensity does not read ``i0``, as the JAX package's eager trace."""
    cdtype = _complex_of(i0.dtype)
    pc = p_chain.to(cdtype)

    def power(st):
        e1 = torch.einsum("...ij,...j->...i", pc,
                          _initial_field(st, L0, M0, N0, cdtype))
        return torch.sum(torch.abs(e1) ** 2, dim=-1)

    if state is not None and state.is_polarized:
        return power(state)
    return (power(PolarizationState(True, 1.0, 0.0))
            + power(PolarizationState(True, 0.0, 1.0))) * i0 / 2


# --- the fixed Jones elements ----------------------------------------------

def _jones(m00, m01, m10, m11, m22=1.0):
    return torch.tensor([[m00, m01, 0.0], [m10, m11, 0.0], [0.0, 0.0, m22]],
                        dtype=torch.complex128)


def jones_polarizer_h():
    return _jones(1.0, 0.0, 0.0, 0.0)


def jones_polarizer_v():
    return _jones(0.0, 0.0, 0.0, 1.0)


def jones_polarizer_l45():
    return _jones(0.5, 0.5, 0.5, 0.5)


def jones_polarizer_l135():
    return _jones(0.5, -0.5, -0.5, 0.5)


def jones_polarizer_rcp():
    return _jones(0.5, 0.5j, -0.5j, 0.5)


def jones_polarizer_lcp():
    return _jones(0.5, -0.5j, 0.5j, 0.5)


def jones_linear_diattenuator(t_min, t_max=1.0, theta=0.0):
    """Diattenuator with amplitude transmissions t_max / t_min at the angle
    theta. The reference's quirks are kept: t_min and t_max act as
    amplitude coefficients, and the off-diagonal is its literal
    ``t_max - t_min cos(theta) sin(theta)``, not the textbook
    (t_max - t_min) cos sin."""
    c, s = math.cos(theta), math.sin(theta)
    m01 = t_max - t_min * c * s
    return _jones(t_max * c**2 + t_min * s**2, m01, m01,
                  t_max * s**2 + t_min * c**2)


def jones_linear_retarder(retardance, theta=0.0):
    """Linear retarder of ``retardance`` radians with its axis at theta."""
    c, s = math.cos(theta), math.sin(theta)
    e = cmath.exp(-1j * retardance / 2)
    ec = cmath.exp(1j * retardance / 2)
    m01 = (e - ec) * c * s
    return _jones(e * c**2 + ec * s**2, m01, m01, e * s**2 + ec * c**2)


def jones_quarter_wave(theta=0.0):
    return jones_linear_retarder(math.pi / 2, theta)


def jones_half_wave(theta=0.0):
    return jones_linear_retarder(math.pi, theta)
