"""Forbes Q-polynomial surfaces (port of ``optiland_pr_tpu/geometry/forbes.py``):
the rotationally symmetric Qbfs and the Q2D freeform.

The Qbfs -> Pn and Q2D -> Pnm basis changes are linear maps whose
coefficients depend only on the (static) term structure, so they are host
matrices (``qbfs_basis_matrix``, ``q2d_basis_matrix``); the Clenshaw sums run
over the basis-changed coefficients. Everything is differentiable with
respect to the coefficients, the conic base and the normalization radius.
Both surfaces are intersected by ``newton_distance``.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .aspheres import _coefficients
from .base import Geometry
from .standard import _conic_sag, _conic_sag_grad

__all__ = ["ForbesQbfs", "ForbesQ2d", "qbfs_basis_matrix",
           "q2d_basis_matrix", "q2d_layout", "abc_q2d"]


@lru_cache(maxsize=None)
def _f_qbfs(n: int) -> float:
    if n == 0:
        return 2.0
    if n == 1:
        return math.sqrt(19) / 2
    return math.sqrt(n * (n + 1) + 3 - _g_qbfs(n - 1) ** 2
                     - _h_qbfs(n - 2) ** 2)


@lru_cache(maxsize=None)
def _g_qbfs(n_minus_1: int) -> float:
    if n_minus_1 == 0:
        return -0.5
    n_minus_2 = n_minus_1 - 1
    return -(1 + _g_qbfs(n_minus_2) * _h_qbfs(n_minus_2)) / _f_qbfs(n_minus_1)


@lru_cache(maxsize=None)
def _h_qbfs(n_minus_2: int) -> float:
    n = n_minus_2 + 2
    return -n * (n - 1) / (2 * _f_qbfs(n_minus_2))


@lru_cache(maxsize=None)
def qbfs_basis_matrix(num_terms: int) -> np.ndarray:
    """M with bs = M @ cs: the Qbfs -> Pn basis change, fed one unit vector
    at a time through its recurrence."""
    m = num_terms - 1
    M = np.zeros((num_terms, num_terms))
    if m < 0:
        return M
    for col in range(num_terms):
        cs = np.zeros(num_terms)
        cs[col] = 1.0
        bs = np.zeros(num_terms)
        bs[m] = cs[m] / _f_qbfs(m)
        if m > 0:
            bs[m - 1] = (cs[m - 1] - _g_qbfs(m - 1) * bs[m]) / _f_qbfs(m - 1)
        for i in range(m - 2, -1, -1):
            bs[i] = (cs[i] - _g_qbfs(i) * bs[i + 1]
                     - _h_qbfs(i) * bs[i + 2]) / _f_qbfs(i)
        M[:, col] = bs
    return M


def clenshaw_qbfs(bs, usq):
    """The Clenshaw alphas of sum_n bs_n P_n(usq); ``bs`` a list."""
    m = len(bs) - 1
    prefix = 2 - 4 * usq
    alphas = [None] * (m + 1)
    alphas[m] = bs[m] + torch.zeros_like(usq)
    if m > 0:
        alphas[m - 1] = bs[m - 1] + prefix * alphas[m]
    for i in range(m - 2, -1, -1):
        alphas[i] = bs[i] + prefix * alphas[i + 1] - alphas[i + 2]
    return alphas


def clenshaw_qbfs_der(bs, usq, alphas0):
    """The first-derivative Clenshaw pass (d/d usq)."""
    m = len(bs) - 1
    prefix = 2 - 4 * usq
    a1 = [torch.zeros_like(usq) for _ in range(m + 1)]
    if m - 1 >= 0:
        a1[m - 1] = -4 * alphas0[m]
    if m - 2 >= 0:
        a1[m - 2] = prefix * a1[m - 1] - 4 * alphas0[m - 1]
    for n in range(m - 3, -1, -1):
        a1[n] = prefix * a1[n + 1] - a1[n + 2] - 4 * alphas0[n + 1]
    return a1


def qbfs_sum(bs, usq):
    """(S, dS/d usq) of the Pn series with coefficients ``bs`` (a list)."""
    al0 = clenshaw_qbfs(bs, usq)
    if len(bs) > 1:
        a1 = clenshaw_qbfs_der(bs, usq, al0)
        return 2 * (al0[0] + al0[1]), 2 * (a1[0] + a1[1])
    return 2 * al0[0], torch.zeros_like(usq)


def _conic_correction(p, r2):
    """The sigma^-1 projection factor and its rho derivative."""
    R = p["radius"]
    is_plane = torch.isinf(R)
    Rs = torch.where(is_plane, 1.0, R)
    c2 = (1.0 / Rs) ** 2
    k = p["conic"]
    rho = torch.sqrt(r2)
    num_arg = 1 - k * c2 * r2
    den_arg = 1 - (k + 1) * c2 * r2
    N = torch.sqrt(torch.where(num_arg > 0, num_arg, 1e-12))
    D = torch.sqrt(torch.where(den_arg > 0, den_arg, 1e-12))
    factor = torch.where(is_plane, 1.0, N / D)
    deriv = torch.where(is_plane, 0.0, (c2 * rho) / (N * D**3))
    return factor, deriv


def _base_sag(p, x, y):
    z = _conic_sag(p["radius"], p["conic"], x, y)
    return torch.where(torch.isinf(p["radius"]), torch.zeros_like(z), z)


class ForbesQbfs(Geometry):
    """z = conic + u^2 (1 - u^2) sum_m a_m Q_m(u^2) / sigma(rho), u = rho /
    norm_radius, zero departure outside u = 1."""

    kind = "forbes_qbfs"

    def __init__(self, num_terms: int):
        self.num_terms = int(num_terms)

    def default_params(self, radius=math.inf, conic=0.0, coefficients=None,
                       norm_radius=1.0, radial_terms=None, **kw) -> dict:
        if coefficients is None and radial_terms:
            coefficients = [radial_terms.get(n, 0.0) for n in
                            range(max(radial_terms.keys()) + 1)]
        return {"radius": float(radius), "conic": float(conic),
                "coefficients": _coefficients(coefficients,
                                              max(self.num_terms, 1)),
                "norm_radius": float(norm_radius)}

    def _poly(self, p, usq):
        """(sum, d(sum)/d(usq)) of the Qbfs series at u^2."""
        if self.num_terms == 0:
            z = torch.zeros_like(usq)
            return z, z
        M = torch.as_tensor(qbfs_basis_matrix(self.num_terms), dtype=usq.dtype,
                            device=usq.device)
        bs = M @ p["coefficients"][: self.num_terms]
        return qbfs_sum([bs[i] for i in range(self.num_terms)], usq)

    def sag(self, p, x, y):
        r2 = x**2 + y**2
        usq = r2 / p["norm_radius"] ** 2
        poly, _ = self._poly(p, usq)
        factor, _ = _conic_correction(p, r2)
        departure = usq * (1 - usq) * factor * poly
        return _base_sag(p, x, y) + torch.where(usq > 1, 0.0, departure)

    def sag_grad(self, p, x, y):
        r2 = x**2 + y**2
        rho = torch.sqrt(r2 + 1e-12)
        base_x, base_y = _conic_sag_grad(p["radius"], p["conic"], x, y)
        nr = p["norm_radius"]
        u = rho / nr
        usq = u**2
        poly, ds_dusq = self._poly(p, usq)
        ds_du = ds_dusq * 2 * u
        factor, dfactor_drho = _conic_correction(p, r2)
        dprefactor_drho = (2 * u - 4 * u**3) / nr
        dpoly_drho = ds_du / nr
        ds_dep_drho = (dprefactor_drho * factor * poly
                       + (usq - usq**2) * dfactor_drho * poly
                       + (usq - usq**2) * factor * dpoly_drho)
        ds_dep_drho = torch.where(u >= 1, 0.0, ds_dep_drho)
        return base_x + ds_dep_drho * (x / rho), \
            base_y + ds_dep_drho * (y / rho)


# --- Forbes Q2D freeform ------------------------------------------------------

@lru_cache(maxsize=None)
def _gamma_q2d(n: int, m: int) -> float:
    if n == 1 and m == 2:
        return 3.0 / 8.0
    if n == 1 and m > 2:
        mm1 = m - 1
        return ((2 * mm1 + 1) / (2 * (mm1 - 1))) * _gamma_q2d(1, mm1)
    nm1 = n - 1
    num = (nm1 + 1) * (2 * m + 2 * nm1 - 1)
    den = (m + nm1 - 2) * (2 * nm1 + 1)
    return (num / den) * _gamma_q2d(nm1, m)


def _kron(i, j):
    return 1 if i == j else 0


def _factorial2(n: int) -> float:
    """n!! (1 for n <= 0), the scipy.special.factorial2 the JAX package
    calls."""
    out = 1
    while n > 1:
        out *= n
        n -= 2
    return float(out)


@lru_cache(maxsize=None)
def _g_q2d_raw(n: int, m: int) -> float:
    if n == 0:
        return _factorial2(2 * m - 1) / (2 ** (m + 1)
                                         * float(math.factorial(m - 1)))
    if n > 0 and m == 1:
        term1 = -((2 * n**2 - 1) * (n**2 - 1)) / (8 * (4 * n**2 - 1))
        return term1 - _kron(n, 1) / 24.0
    nt1 = 2 * n * (m + n - 1) - m
    nt2 = (n + 1) * (2 * m + 2 * n - 1)
    den = (m + 2 * n - 2) * (m + 2 * n - 1) * (m + 2 * n) * (2 * n + 1)
    return -(nt1 * nt2) / den * _gamma_q2d(n, m)


@lru_cache(maxsize=None)
def _f_q2d_raw(n: int, m: int) -> float:
    if n == 0 and m == 1:
        return 0.25
    if n == 0:
        return (m**2 * _factorial2(2 * m - 3)
                / (2 ** (m + 1) * float(math.factorial(m - 1))))
    if n > 0 and m == 1:
        term1 = (4 * (n - 1) ** 2 * n**2 + 1) / (8 * (2 * n - 1) ** 2)
        return term1 + 11.0 / 32.0 * _kron(n, 1)
    chi = m + n - 2
    num = 2 * n * chi * (3 - 5 * m + 4 * n * chi) \
        + m**2 * (3 - m + 4 * n * chi)
    den = (m + 2 * n - 3) * (m + 2 * n - 2) * (m + 2 * n - 1) * (2 * n - 1)
    return num / den * _gamma_q2d(n, m)


@lru_cache(maxsize=None)
def _f_q2d(n: int, m: int) -> float:
    if n == 0:
        return math.sqrt(_f_q2d_raw(0, m))
    return math.sqrt(_f_q2d_raw(n, m) - _g_q2d(n - 1, m) ** 2)


@lru_cache(maxsize=None)
def _g_q2d(n: int, m: int) -> float:
    return _g_q2d_raw(n, m) / _f_q2d(n, m)


_ABC_Q2D_SPECIAL = {(1, 0): (2, -1, 0), (1, 1): (-4 / 3, -8 / 3, -11 / 3),
                    (1, 2): (9 / 5, -24 / 5, 0), (2, 0): (3, -2, 0),
                    (3, 0): (5, -4, 0)}


@lru_cache(maxsize=None)
def abc_q2d(n: int, m: int):
    """(a, b, c) of the Pnm recurrence at (n, m)."""
    if (m, n) in _ABC_Q2D_SPECIAL:
        return _ABC_Q2D_SPECIAL[(m, n)]
    d = (4 * n**2 - 1) * (m + n - 2) * (m + 2 * n - 3)
    if d == 0:
        d = 1e-99
    a = ((2 * n - 1) * (m + 2 * n - 2)
         * (4 * n * (m + n - 2) + (m - 3) * (2 * m - 1))) / d
    b = (-2 * (2 * n - 1) * (m + 2 * n - 3) * (m + 2 * n - 2)
         * (m + 2 * n - 1)) / d
    c = (n * (2 * n - 3) * (m + 2 * n - 1) * (2 * m + 2 * n - 3)) / d
    return a, b, c


@lru_cache(maxsize=None)
def q2d_basis_matrix(num_terms: int, m: int) -> np.ndarray:
    """ds = M @ cns: the Q2D -> Pnm basis change."""
    m = abs(m)
    n_max = num_terms - 1
    M = np.zeros((num_terms, num_terms))
    for col in range(num_terms):
        cns = np.zeros(num_terms)
        cns[col] = 1.0
        ds = np.zeros(num_terms)
        ds[n_max] = cns[n_max] / _f_q2d(n_max, m)
        for n in range(n_max - 1, -1, -1):
            ds[n] = (cns[n] - _g_q2d(n, m) * ds[n + 1]) / _f_q2d(n, m)
        M[:, col] = ds
    return M


def clenshaw_q2d(ds, m, usq):
    """The Clenshaw alphas of sum_n ds_n P_n^m(usq); ``ds`` a list."""
    n_max = len(ds) - 1
    al = [torch.zeros_like(usq) for _ in range(n_max + 3)]
    al[n_max] = ds[n_max] + torch.zeros_like(usq)
    if n_max >= 1:
        a, b, _ = abc_q2d(n_max - 1, m)
        al[n_max - 1] = ds[n_max - 1] + (a + b * usq) * al[n_max]
    for n in range(n_max - 2, -1, -1):
        a, b, _ = abc_q2d(n, m)
        _, _, c = abc_q2d(n + 1, m)
        al[n] = ds[n] + (a + b * usq) * al[n + 1] - c * al[n + 2]
    return al


def clenshaw_q2d_der(ds, m, usq, al0):
    """The first-derivative Clenshaw pass (d/d usq)."""
    n_max = len(ds) - 1
    al = [torch.zeros_like(usq) for _ in range(n_max + 3)]
    if n_max - 1 >= 0:
        _, b, _ = abc_q2d(n_max - 1, m)
        al[n_max - 1] = b * al0[n_max]
        for n in range(n_max - 2, -1, -1):
            a, b, _ = abc_q2d(n, m)
            _, _, c = abc_q2d(n + 1, m)
            al[n] = b * al0[n + 1] + (a + b * usq) * al[n + 1] - c * al[n + 2]
    return al


def q2d_sum(al, m, num_coeffs):
    """The Q2D readout of the alphas: al_0 / 2, less 2/5 al_3 for m = 1."""
    s = 0.5 * al[0]
    if m == 1 and num_coeffs - 1 > 2:
        s = s - 2.0 / 5.0 * al[3]
    return s


def q2d_layout(terms: tuple):
    """(n_m0, len_a, len_b): the static grouping of a Q2D (n, m) term list,
    the rotational (m = 0) terms' count and, per |m|, the cosine (m > 0) and
    sine (m < 0) groups' lengths."""
    n_m0 = max([n for n, m in terms if m == 0], default=-1) + 1
    max_m = max([abs(m) for n, m in terms if m != 0], default=0)
    len_a = [0] * (max_m + 1)
    len_b = [0] * (max_m + 1)
    for n, m in terms:
        if m > 0:
            len_a[m] = max(len_a[m], n + 1)
        elif m < 0:
            len_b[-m] = max(len_b[-m], n + 1)
    return n_m0, len_a, len_b


class ForbesQ2d(Geometry):
    """The Forbes Q2D freeform:

    z = z_base + sigma^-1 [u^2 (1 - u^2) sum_n a_n Q_n(u^2)
                           + sum_m u^m (cos, sin)(m theta) sum_n c Q_n^m(u^2)]

    ``terms`` is the ordered (n, m) list: m > 0 cosine, m < 0 sine, m = 0
    rotational; the coefficient values live in the parameters."""

    kind = "forbes_q2d"

    def __init__(self, terms: tuple):
        self.terms = tuple((int(n), int(m)) for n, m in terms)
        self.n_m0, self.len_a, self.len_b = q2d_layout(self.terms)
        self.max_m = len(self.len_a) - 1

    def default_params(self, radius=math.inf, conic=0.0, coefficients=None,
                       norm_radius=1.0, **kw) -> dict:
        return {"radius": float(radius), "conic": float(conic),
                "coefficients": _coefficients(coefficients,
                                              max(len(self.terms), 1)),
                "norm_radius": float(norm_radius)}

    def grouped(self, c):
        """(m = 0 list, per-m cosine lists, per-m sine lists) of the
        coefficients ``c``, zero where no term is given."""
        zero = torch.zeros((), dtype=c.dtype, device=c.device)
        cm0 = [zero] * self.n_m0
        ams = [[zero] * self.len_a[m] for m in range(self.max_m + 1)]
        bms = [[zero] * self.len_b[m] for m in range(self.max_m + 1)]
        for idx, (n, m) in enumerate(self.terms):
            if m == 0:
                cm0[n] = c[idx]
            elif m > 0:
                ams[m][n] = c[idx]
            else:
                bms[-m][n] = c[idx]
        return cm0, ams, bms

    def _series(self, p, u, theta):
        """(poly_m0, dpoly_m0_du, poly_mgt0, dr_mgt0, dt_mgt0)."""
        usq = u * u
        cm0, ams, bms = self.grouped(p["coefficients"])
        zero = torch.zeros_like(u)

        def basis(M, coefs):
            M = torch.as_tensor(M, dtype=u.dtype, device=u.device)
            ds = M @ torch.stack(coefs)
            return [ds[i] for i in range(len(coefs))]

        if cm0:
            s_m0, ds_dusq = qbfs_sum(basis(qbfs_basis_matrix(len(cm0)), cm0),
                                     usq)
            d_m0_du = ds_dusq * 2 * u
        else:
            s_m0, d_m0_du = zero, zero

        poly_terms, dr_terms, dt_terms = [], [], []
        for m in range(1, self.max_m + 1):
            s_a = s_b = sp_a = sp_b = zero
            for coefs, is_a in ((ams[m], True), (bms[m], False)):
                if not coefs:
                    continue
                ds = basis(q2d_basis_matrix(len(coefs), m), coefs)
                al0 = clenshaw_q2d(ds, m, usq)
                al1 = clenshaw_q2d_der(ds, m, usq, al0)
                s = q2d_sum(al0, m, len(coefs))
                sp = q2d_sum(al1, m, len(coefs))
                if is_a:
                    s_a, sp_a = s, sp
                else:
                    s_b, sp_b = s, sp
            um = u**m
            cost = torch.cos(m * theta)
            sint = torch.sin(m * theta)
            poly_terms.append(um * (cost * s_a + sint * s_b))
            umm1 = u ** (m - 1)
            aterm = cost * (2 * usq * sp_a + m * s_a)
            bterm = sint * (2 * usq * sp_b + m * s_b)
            dr_terms.append(umm1 * (aterm + bterm))
            dt_terms.append(m * um * (-s_a * sint + s_b * cost))

        poly_mgt0 = sum(poly_terms) if poly_terms else zero
        dr_mgt0 = sum(dr_terms) if dr_terms else zero
        dt_mgt0 = sum(dt_terms) if dt_terms else zero
        return s_m0, d_m0_du, poly_mgt0, dr_mgt0, dt_mgt0

    @staticmethod
    def _theta(x, y, rho):
        return torch.atan2(y, torch.where(rho < 1e-12, x + 1e-12, x))

    def sag(self, p, x, y):
        r2 = x**2 + y**2
        rho = torch.sqrt(r2 + 1e-12)
        u = rho / p["norm_radius"]
        s_m0, _, s_mgt0, _, _ = self._series(p, u, self._theta(x, y, rho))
        factor, _ = _conic_correction(p, r2)
        usq = u * u
        departure = usq * (1 - usq) * factor * s_m0 + factor * s_mgt0
        return _base_sag(p, x, y) + torch.where(u > 1, 0.0, departure)

    def sag_grad(self, p, x, y):
        r2 = x**2 + y**2
        rho = torch.sqrt(r2 + 1e-12)
        base_x, base_y = _conic_sag_grad(p["radius"], p["conic"], x, y)
        nr = p["norm_radius"]
        u = rho / nr
        usq = u * u
        s_m0, d_m0_du, s_mgt0, dr_mgt0, dt_mgt0 = self._series(
            p, u, self._theta(x, y, rho))
        factor, dfactor_drho = _conic_correction(p, r2)
        dpref_drho = (2 * u - 4 * u**3) / nr
        dpoly_drho = d_m0_du / nr
        dS0 = (dpref_drho * factor * s_m0
               + (usq - usq**2) * dfactor_drho * s_m0
               + (usq - usq**2) * factor * dpoly_drho)
        dSg_drho = dfactor_drho * s_mgt0 + factor * dr_mgt0 / nr
        dS_drho = torch.where(u >= 1, 0.0, dS0 + dSg_drho)
        dS_dtheta = torch.where(u >= 1, 0.0, factor * dt_mgt0)
        inv_rho = 1.0 / rho
        dfdx = base_x + dS_drho * x * inv_rho - dS_dtheta * y * inv_rho**2
        dfdy = base_y + dS_drho * y * inv_rho + dS_dtheta * x * inv_rho**2
        return dfdx, dfdy
