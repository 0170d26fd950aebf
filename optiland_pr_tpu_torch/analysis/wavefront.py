"""Wavefront analysis: OPD relative to an exit-pupil reference sphere
(port of ``optiland_pr_tpu/analysis/wavefront.py``, without the matplotlib
views).

Strategies: the chief-ray sphere (default), the centroid-anchored sphere
and the best-fit sphere. Everything is torch on the traced rays, so the RMS
wavefront error is differentiable and serves as a merit operand.

On the card (or under ``engine_override("kernel")``) the chief-ray strategy
of an untilted conic/plane system goes through K1's split-OPD mode, with
the chief ray as sample 0 of the same launch, so that every path-scale
magnitude either stays out of the per-ray float32 sums or is common to the
chief and the pupil rays and cancels (``_wavefront_data_split``); its
gradient is K2's split mode.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.distributions import generate_distribution
from ..core.zernike import ZernikeFit, lstsq_min_norm
from ..system.model import OpticModel, field_coords, positions_from_params
from ..trace import real as real_trace
from ..trace.paraxial import Paraxial, system_arrays

__all__ = ["WavefrontData", "wavefront_data", "wavefront_grid",
           "Wavefront", "OPD", "OPDFan", "ZernikeOPD", "fit_and_remove_tilt"]


@dataclasses.dataclass
class WavefrontData:
    """Per-(field, wavelength) wavefront results."""
    pupil_x: torch.Tensor
    pupil_y: torch.Tensor
    pupil_z: torch.Tensor
    opd: torch.Tensor            # in waves
    intensity: torch.Tensor
    radius: torch.Tensor         # the reference sphere's radius
    center: tuple | None = None  # its center (x, y, z)


def _opd_image_to_xp(rays, xc, yc, zc, R, n_image):
    """Optical path from the image-plane intersection back to the
    reference sphere."""
    xr, yr, zr = rays.x, rays.y, rays.z
    L, M, N = -rays.L, -rays.M, -rays.N
    a = L**2 + M**2 + N**2
    b = 2 * (L * (xr - xc) + M * (yr - yc) + N * (zr - zc))
    c = (xr**2 + yr**2 + zr**2
         - 2 * (xr * xc + yr * yc + zr * zc)
         + xc**2 + yc**2 + zc**2 - R**2)
    d = b**2 - 4 * a * c
    ok = d >= 0
    # the double where: the value is 0 where d < 0, the gradient finite
    sq = torch.where(ok, torch.sqrt(torch.where(ok, d, 1.0)), 0.0)
    t = (-b - sq) / (2 * a)
    t = torch.where(t < 0, (-b + sq) / (2 * a), t)
    return n_image * t


def _correct_tilt(model, params, field, opd, xs, ys, epd):
    """Remove the launch plane's tilt for angle fields."""
    if model.field_type != "angle":
        return opd
    hx, hy = field
    fields = params["fields"]
    max_field = torch.max(torch.sqrt(torch.sum(fields**2, dim=1)))
    tx = torch.tan(torch.deg2rad(hx * max_field))
    ty = torch.tan(torch.deg2rad(hy * max_field))
    uz = 1.0 / torch.sqrt(1.0 + tx**2 + ty**2)
    ux, uy = tx * uz, ty * uz
    return opd + ux * (xs * epd / 2) + uy * (ys * epd / 2)


def _split_wavefront_eligible(model, device) -> bool:
    """The float32 split-OPD wavefront path applies to untilted conic/plane
    systems that K1 takes, for pupil samples on the card or under
    ``engine_override("kernel")`` (and never under "eager")."""
    from ..kernels.gen_trace import gen_eligible, supports_split_opd
    from ..trace import engine
    if not (gen_eligible(model) and supports_split_opd(model)):
        return False
    if engine._FORCE is not None:
        return engine._FORCE == "kernel"
    return torch.device(device).type == "cuda"


def _opd_sphere_dev(ux, uy, uz, L, M, N, R, n_image):
    """n (t - R): the back-projection distance onto the reference sphere as
    a deviation from its radius, free of cancellation for |u| << R (u = the
    ray's point minus the sphere's center): t - R = w + (w^2 - |u|^2) / (R +
    sqrt(R^2 + w^2 - |u|^2)) with w = u . ray direction. The omitted n R
    cancels in every chief-relative difference."""
    w = ux * L + uy * M + uz * N
    h = w * w - (ux * ux + uy * uy + uz * uz)
    root = torch.sqrt(torch.clamp(R * R + h, min=0.0))
    return n_image * (w + h / (R + root))


def _wavefront_data_split(model, params, field, wavelength, Px, Py
                          ) -> WavefrontData:
    """The chief-ray strategy through K1's split-OPD mode: the chief ray is
    sample 0 of the same launch (identical base, identical frames, so the
    bases cancel exactly), z stays local to the image vertex, and the
    reference sphere's back-projection is taken in deviation form."""
    from ..kernels.gen_trace import gen_trace_conic
    from ..trace.raygen import vig_factor

    par = Paraxial(model, params)
    _, n_arr, _ = system_arrays(model, params, wavelength)
    n_image = n_arr[-1]
    hx, hy = field
    vx_, vy_ = vig_factor(model, params, hx, hy)
    zero = Px.new_zeros(1)
    rays, _ = gen_trace_conic(
        model, params, torch.cat([zero, Px * (1 - vx_)]),
        torch.cat([zero, Py * (1 - vy_)]), wavelength, Hx=hx, Hy=hy,
        final_prop=True, opd_split=True, keep_local_z=True)

    # every z is local to the image vertex; the exit pupil sits at XPL()
    xpl = par.XPL()
    xc, yc, zc = rays.x[0], rays.y[0], rays.z[0]
    R = torch.sqrt(xc**2 + yc**2 + (zc - xpl) ** 2)
    epd = par.EPD()
    # w = u . ray direction: the quadratic's -d.u with d the reversed
    # direction; the squared terms do not see the sign
    dev_img = _opd_sphere_dev(rays.x - xc, rays.y - yc, rays.z - zc,
                              rays.L, rays.M, rays.N, R, n_image)
    opd = _correct_tilt(model, params, field, rays.opd - dev_img,
                        torch.cat([zero, Px]), torch.cat([zero, Py]), epd)
    opd_wv = (opd[0] - opd[1:]) / (wavelength * 1e-3)

    # pupil coordinates for display and PSF sampling: R-scale is enough
    t = (dev_img[1:] + n_image * R) / n_image
    z_img = positions_from_params(params)[-1]
    return WavefrontData(pupil_x=rays.x[1:] - t * rays.L[1:],
                         pupil_y=rays.y[1:] - t * rays.M[1:],
                         pupil_z=rays.z[1:] + z_img - t * rays.N[1:],
                         opd=opd_wv, intensity=rays.intensity[1:], radius=R,
                         center=(xc, yc, zc + z_img))


def _sphere_fit(strategy, vf, xr, yr, zr, wx, wy, wz):
    """(xc, yc, zc, R) of the centroid-anchored or the best-fit sphere."""
    if strategy == "centroid_sphere":
        # uniform weights over the valid rays, then a 3-sigma trim on the
        # image-plane distances
        nv = torch.sum(vf)
        cx, cy, cz = (torch.sum(v * vf) / nv for v in (xr, yr, zr))
        d_img = torch.sqrt((xr - cx) ** 2 + (yr - cy) ** 2 + (zr - cz) ** 2)
        mean_d = torch.sum(d_img * vf) / nv
        std_d = torch.sqrt(torch.sum((d_img - mean_d) ** 2 * vf) / nv)
        keep = vf * (d_img <= mean_d + 3.0 * std_d)
        use_trim = (std_d > 0) & (torch.sum(keep) >= 4)
        w = torch.where(use_trim, keep, vf)
        nw = torch.sum(w)
        xc, yc, zc = (torch.sum(v * w) / nw for v in (xr, yr, zr))
        d_wf = torch.sqrt((wx - xc) ** 2 + (wy - yc) ** 2 + (wz - zc) ** 2)
        return xc, yc, zc, torch.sum(w * d_wf) / nw
    # the least-squares sphere through the wavefront points:
    # 2x xc + 2y yc + 2z zc + (R^2 - |c|^2) = |p|^2
    A = torch.stack([wx, wy, wz, torch.ones_like(wx)], dim=1) * vf[:, None]
    b = (wx**2 + wy**2 + wz**2) * vf
    c = lstsq_min_norm(A, b)
    xc, yc, zc = c[0] / 2, c[1] / 2, c[2] / 2
    return xc, yc, zc, torch.sqrt(c[3] + xc**2 + yc**2 + zc**2)


def wavefront_data(model: OpticModel, params, field, wavelength, Px, Py,
                   strategy: str = "chief_ray",
                   engine: str = "auto") -> WavefrontData:
    """Wavefront data for one field and wavelength. ``engine`` goes to the
    trace dispatch; "eager" also bypasses the split-OPD path."""
    if (strategy == "chief_ray" and engine != "eager"
            and _split_wavefront_eligible(model, Px.device)):
        return _wavefront_data_split(model, params, field, wavelength,
                                     Px, Py)
    from ..trace.engine import final_rays
    from ..trace.raygen import vig_factor

    par = Paraxial(model, params)
    pos = positions_from_params(params)
    _, n_arr, _ = system_arrays(model, params, wavelength)
    n_image = n_arr[-1]
    hx, hy = field
    # the vignetting scale is applied here and again in the ray generation,
    # as the JAX package (and the reference it follows) does
    vx_, vy_ = vig_factor(model, params, hx, hy)
    rays = final_rays(model, params, hx, hy, wavelength, Px * (1 - vx_),
                      Py * (1 - vy_), final_prop=True, engine=engine)
    epd = par.EPD()

    if strategy == "chief_ray":
        pupil_z = par.XPL() + pos[-1]
        chief = real_trace.trace_generic(model, params, hx, hy, 0.0, 0.0,
                                         wavelength)
        xc, yc, zc = chief.x, chief.y, chief.z
        R = torch.sqrt(xc**2 + yc**2 + (zc - pupil_z) ** 2)
        opd_ref = chief.opd - _opd_image_to_xp(chief, xc, yc, zc, R, n_image)
        opd_ref = _correct_tilt(model, params, field, opd_ref,
                                torch.zeros_like(opd_ref),
                                torch.zeros_like(opd_ref), epd)
        opd_img = _opd_image_to_xp(rays, xc, yc, zc, R, n_image)
        opd = _correct_tilt(model, params, field, rays.opd - opd_img, Px, Py,
                            epd)
        opd_wv = (opd_ref - opd) / (wavelength * 1e-3)
    elif strategy in ("centroid_sphere", "best_fit_sphere"):
        # tilt-correct the path lengths first, so the back-projected
        # wavefront points use them; piston is the unweighted mean over the
        # rays that pass
        rays = rays.replace(opd=_correct_tilt(model, params, field, rays.opd,
                                              Px, Py, epd))
        valid = (torch.isfinite(rays.x) & torch.isfinite(rays.y)
                 & torch.isfinite(rays.z) & torch.isfinite(rays.L)
                 & torch.isfinite(rays.M) & torch.isfinite(rays.N)
                 & torch.isfinite(rays.opd) & (rays.intensity != 0))
        vf = valid.to(rays.opd.dtype)

        def m(v):
            return torch.where(valid, v, 0.0)
        xr, yr, zr = m(rays.x), m(rays.y), m(rays.z)
        # the wavefront points: back-projected by the path length
        s = m(rays.opd) / n_image
        wx, wy, wz = xr - s * m(rays.L), yr - s * m(rays.M), \
            zr - s * m(rays.N)
        xc, yc, zc, R = _sphere_fit(strategy, vf, xr, yr, zr, wx, wy, wz)
        opd_img = _opd_image_to_xp(rays, xc, yc, zc, R, n_image)
        opd = rays.opd - opd_img
        lit = rays.intensity > 0
        mean_opd = torch.sum(torch.where(lit, opd, 0.0)) \
            / torch.clamp(torch.sum(lit), min=1)
        opd_wv = (mean_opd - opd) / (wavelength * 1e-3)
    else:
        raise ValueError(f"unknown wavefront strategy {strategy}")

    t = opd_img / n_image
    return WavefrontData(pupil_x=rays.x - t * rays.L,
                         pupil_y=rays.y - t * rays.M,
                         pupil_z=rays.z - t * rays.N, opd=opd_wv,
                         intensity=rays.intensity, radius=R,
                         center=(xc, yc, zc))


def _stack(items, F, W) -> WavefrontData:
    """One WavefrontData whose every leaf has leading axes [F, W]."""
    def grid(vals):
        return torch.stack([torch.as_tensor(v) for v in vals]).reshape(
            (F, W) + tuple(torch.as_tensor(vals[0]).shape))
    out = {f.name: grid([getattr(d, f.name) for d in items])
           for f in dataclasses.fields(WavefrontData) if f.name != "center"}
    if items[0].center is None:
        return WavefrontData(**out)
    return WavefrontData(**out, center=tuple(
        grid([d.center[i] for d in items]) for i in range(3)))


def wavefront_grid(model: OpticModel, params, fields, wavelengths, Px, Py,
                   strategy: str = "chief_ray") -> WavefrontData:
    """The fields x wavelengths wavefront grid: every leaf of the returned
    WavefrontData has leading axes [F, W]. The (field, wavelength) pairs
    run one after another, as the JAX package runs them on an accelerator;
    on the card each is one K1 launch."""
    data = [wavefront_data(model, params, f, wl, Px, Py, strategy=strategy)
            for f in fields for wl in wavelengths]
    return _stack(data, len(fields), len(wavelengths))


def fit_and_remove_tilt(data: WavefrontData, remove_piston: bool = False,
                        ridge: float = 1e-12):
    """Weighted least-squares piston and tilt removal."""
    x, y, w, opd = data.pupil_x, data.pupil_y, data.intensity, data.opd
    X = torch.stack([torch.ones_like(x), x, y], dim=1)
    sw = torch.sqrt(w)
    Xw = X * sw[:, None]
    XtX = Xw.T @ Xw + ridge * torch.eye(3, dtype=x.dtype, device=x.device)
    coeffs = torch.linalg.solve(XtX, Xw.T @ (opd * sw))
    if not remove_piston:
        coeffs = torch.cat([torch.zeros_like(coeffs[:1]), coeffs[1:]])
    return opd - X @ coeffs


class Wavefront:
    """The wavefront of an ``Optic`` at its fields and wavelengths, built on
    ``device`` (default: the card) in ``dtype`` (default float64)."""

    def __init__(self, optic, fields="all", wavelengths="all",
                 num_rays: int = 12, distribution: str = "hexapolar",
                 strategy: str = "chief_ray", remove_tilt: bool = False,
                 device=None, dtype=None):
        self.optic = optic
        model, params = optic.build(device, dtype)
        if fields == "all":
            # from the host's float64 fields, so that the keys of ``data``
            # do not depend on the parameters' dtype
            fields = field_coords({"fields": torch.tensor(
                [f[:2] for f in optic.fields] or [(0.0, 0.0)],
                dtype=torch.float64)})
        if wavelengths == "all":
            wavelengths = list(optic.wavelengths)
        elif wavelengths == "primary":
            wavelengths = [optic.primary_wavelength]
        self.fields = fields
        self.wavelengths = wavelengths
        ref = params["wavelengths"]
        Px, Py = generate_distribution(distribution, num_rays,
                                       dtype=ref.dtype, device=ref.device)
        self.distribution_x, self.distribution_y = Px, Py
        grid = wavefront_grid(model, params, list(fields), list(wavelengths),
                              Px, Py, strategy=strategy)
        self.data = {}
        for i, f in enumerate(fields):
            for j, wl in enumerate(wavelengths):
                d = WavefrontData(
                    **{k.name: getattr(grid, k.name)[i, j]
                       for k in dataclasses.fields(WavefrontData)
                       if k.name != "center"},
                    center=tuple(c[i, j] for c in grid.center))
                if remove_tilt:
                    d = dataclasses.replace(d, opd=fit_and_remove_tilt(d))
                self.data[(f, wl)] = d

    def get_data(self, field, wl) -> WavefrontData:
        return self.data[(field, wl)]


class OPD(Wavefront):
    """The OPD map of one field and wavelength."""

    def __init__(self, optic, field, wavelength, num_rings: int = 15,
                 strategy: str = "chief_ray", remove_tilt: bool = False,
                 device=None, dtype=None):
        super().__init__(optic, fields=[field], wavelengths=[wavelength],
                         num_rays=num_rings, distribution="hexapolar",
                         strategy=strategy, remove_tilt=remove_tilt,
                         device=device, dtype=dtype)
        self.field = field
        self.wavelength = wavelength

    def rms(self):
        """Unweighted RMS over the rays with nonzero intensity."""
        d = self.get_data(self.field, self.wavelength)
        valid = d.intensity > 0
        n = torch.clamp(torch.sum(valid), min=1)
        return torch.sqrt(torch.sum(torch.where(valid, d.opd**2, 0.0)) / n)

    def peak_to_valley(self):
        d = self.get_data(self.field, self.wavelength)
        opd = torch.where(d.intensity > 0, d.opd, 0.0)
        return torch.max(opd) - torch.min(opd)


class ZernikeOPD:
    """Zernike decomposition of the OPD map."""

    def __init__(self, optic, field, wavelength, num_rings: int = 15,
                 zernike_type: str = "fringe", num_terms: int = 37,
                 device=None, dtype=None):
        self.opd = OPD(optic, field, wavelength, num_rings=num_rings,
                       device=device, dtype=dtype)
        d = self.opd.get_data(field, wavelength)
        # normalized exit-pupil coordinates
        px = d.pupil_x / torch.max(torch.abs(d.pupil_x))
        py = d.pupil_y / torch.max(torch.abs(d.pupil_y))
        self.fit = ZernikeFit(px, py, d.opd, zernike_type, num_terms)

    @property
    def coeffs(self):
        return self.fit.coeffs


class OPDFan(Wavefront):
    """Tangential and sagittal OPD fans: the wavefront error along the Py
    axis (Px = 0) and the Px axis (Py = 0), the cross distribution."""

    def __init__(self, optic, fields="all", wavelengths="all",
                 num_rays: int = 100, device=None, dtype=None):
        super().__init__(optic, fields=fields, wavelengths=wavelengths,
                         num_rays=num_rays, distribution="cross",
                         device=device, dtype=dtype)
        ref = self.distribution_x
        self.pupil_coord = torch.linspace(-1, 1, num_rays, dtype=ref.dtype,
                                          device=ref.device)
