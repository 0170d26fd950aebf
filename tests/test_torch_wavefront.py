"""The port's wavefront path against the JAX package, on the CPU: the exit
pupil (``Paraxial.XPL``), ``trace_generic``, the Zernike fit, the
wavefront data of all three strategies and its grid, OPD maps and fans,
``ZernikeOPD``, the FFT PSF and MTF, the wavefront operands, and K1/K2
sub-slice (g): the Kahan-compensated and split-OPD modes of the kernels'
plain versions.

Tolerances:
- float64 against float64 (the JAX package's XLA path, the port's eager
  trace): XPL and the working F-number rtol 1e-10; traced rays atol 1e-9 mm
  and 1e-12 in direction (as tests/test_torch_trace.py); OPD in waves,
  pupil coordinates and Zernike coefficients atol 1e-7; the PSF atol 1e-8
  (of 100 at the diffraction limit) and the MTF atol 1e-8; operand values
  rtol 1e-8 and gradients rtol 1e-6 with atol 1e-9 x max|g| (sums of many
  products reordered);
- the plain K1 (float32) against the Pallas K1 in interpret mode, split and
  Kahan: positions rtol 1e-4 / atol 2e-4 mm scaled by the system's size
  (Hubble: atol 2e-2 mm, tests/test_pallas_widened.py:108-141), directions
  atol 1e-5, OPD (the split mode's deviation) atol 2e-3 mm, intensity rtol
  1e-6, the split base rtol 1e-6, lost-ray masks equal;
- the plain K2 split against the Pallas K2 in interpret mode: rtol 3e-3 with
  atol 3e-3 x max|g| (tests/test_pallas_grad.py:45-76);
- the split and Kahan float32 error bounds of tests/test_pallas_grad.py:
  323-337 and :368-420 and the meter-scale split wavefront bounds of
  tests/test_analysis.py:240-279, each with its own bound, the port's plain
  version against the port's float64 eager trace;
- the wavefront operands through the kernels' plain versions (float32)
  against the float64 eager path: value rtol 1e-3, gradient rtol 2e-2 with
  atol 2e-2 x max|g| (float32 path lengths of ~70 mm against wavefront
  errors of ~1 wave, 5.5e-4 mm).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optiland_pr_tpu.analysis.mtf as jmtf
import optiland_pr_tpu.analysis.wavefront as jwf
import optiland_pr_tpu.kernels.pallas_trace as jpt
import optiland_pr_tpu.optimize as jopt
import optiland_pr_tpu_torch.analysis.wavefront as twf
import optiland_pr_tpu_torch.kernels.gen_trace as tgt
import optiland_pr_tpu_torch.optimize as topt
from _torch_systems import builders, jax_flags_as_port
from optiland_pr_tpu.analysis.psf import get_working_FNO as j_fno
from optiland_pr_tpu.core.distributions import generate_distribution as jgd
from optiland_pr_tpu.core.zernike import ZernikeFit as JZernikeFit
from optiland_pr_tpu.kernels.pallas_grad import diff_gen_trace
from optiland_pr_tpu.system.model import positions_from_params as jpositions
from optiland_pr_tpu.trace import real as j_real
from optiland_pr_tpu_torch.analysis import FFTMTF, OPDFan, ZernikeOPD
from optiland_pr_tpu_torch.analysis.psf import get_working_FNO as t_fno
from optiland_pr_tpu_torch.core.distributions import \
    generate_distribution as tgd
from optiland_pr_tpu_torch.core.zernike import ZernikeFit
from optiland_pr_tpu_torch.kernels.gen_grad import gen_trace_bwd_plain
from optiland_pr_tpu_torch.trace import real as t_real
from optiland_pr_tpu_torch.trace.engine import engine_override, final_rays
from optiland_pr_tpu_torch.trace.paraxial import Paraxial

F32, F64 = torch.float32, torch.float64
WF_FIELD = (0.0, 0.7)        # the Cooke triplet's
SINGLET_FIELD = (0.0, 0.6)   # the singlet's: 3 degrees
# hexapolar rings of every float64 JAX reference: one shape of bundle, so
# their eager operations compile once for the file
RINGS = 3


def _pupil(n, seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    return ((r * np.cos(th)).astype(np.float32),
            (r * np.sin(th)).astype(np.float32))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


@pytest.fixture(scope="module")
def cooke():
    """The Cooke triplet in both packages, float64 on the CPU."""
    jb, tb = builders("CookeTriplet")
    return jb, tb, jb().build(), tb().build(device="cpu")


@pytest.fixture(scope="module")
def singlet():
    """A plain singlet in both packages, float64 on the CPU: the costlier
    JAX references trace 3 surfaces."""
    jb, tb = builders("Singlet")
    return jb, tb, jb().build(), tb().build(device="cpu")


# ---------------------------------------------------------------------------
# first-order optics, trace_generic, the Zernike fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CookeTriplet", "HubbleTelescope"])
def test_xpl_matches_jax(name):
    jb, tb = builders(name)
    jpar = jb().paraxial
    tpar = Paraxial(*tb().build(device="cpu"))
    for q in ("XPL", "EPL", "EPD"):
        np.testing.assert_allclose(float(getattr(tpar, q)()),
                                   float(getattr(jpar, q)()), rtol=1e-10,
                                   err_msg=q)


def test_trace_generic_and_working_fno_match_jax(cooke):
    _, _, (jm, jp), (tm, tp) = cooke
    # the working F-number's five rays, so both traces share their shapes
    px = np.array([0.0, 0.0, 0.0, 1.0, -1.0])
    py = np.array([0.0, 1.0, -1.0, 0.0, 0.0])
    rj = j_real.trace_generic(jm, jp, 0.0, 0.7, px, py, 0.55)
    rt = t_real.trace_generic(tm, tp, 0.0, 0.7, torch.tensor(px),
                              torch.tensor(py), 0.55)
    for k in ("x", "y", "z", "opd"):
        np.testing.assert_allclose(_np(getattr(rt, k)),
                                   np.asarray(getattr(rj, k)), rtol=0,
                                   atol=1e-9, err_msg=k)
    for k in ("L", "M", "N"):
        np.testing.assert_allclose(_np(getattr(rt, k)),
                                   np.asarray(getattr(rj, k)), rtol=0,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_allclose(float(t_fno(tm, tp, WF_FIELD, 0.55)),
                               float(j_fno(jm, jp, WF_FIELD, 0.55)),
                               rtol=1e-10)


@pytest.mark.parametrize("kind,num_terms,n", [("fringe", 37, 127),
                                              ("noll", 21, 127),
                                              ("standard", 15, 127),
                                              ("fringe", 16, 7)])
def test_zernike_fit_matches_jax(kind, num_terms, n):
    """The last case has fewer points than terms: the minimum-norm
    solution of a rank-deficient fit, as the JAX package's lstsq gives."""
    rng = np.random.default_rng(num_terms)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    x, y = r * np.cos(th), r * np.sin(th)
    z = rng.normal(size=n)
    fj = JZernikeFit(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), kind,
                     num_terms)
    ft = ZernikeFit(torch.tensor(x), torch.tensor(y), torch.tensor(z), kind,
                    num_terms)
    np.testing.assert_allclose(_np(ft.coeffs), np.asarray(fj.coeffs),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(float(ft.residual_rms),
                               float(fj.residual_rms), rtol=1e-7, atol=1e-9)


# ---------------------------------------------------------------------------
# wavefront data, grid, OPD, Zernike OPD, PSF and MTF (float64)
# ---------------------------------------------------------------------------

def _hold_wavefront(dt, dj):
    for k in ("opd", "pupil_x", "pupil_y", "pupil_z"):
        np.testing.assert_allclose(_np(getattr(dt, k)),
                                   np.asarray(getattr(dj, k)), rtol=0,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(_np(dt.intensity), np.asarray(dj.intensity),
                               rtol=1e-12)
    np.testing.assert_allclose(_np(dt.radius), np.asarray(dj.radius),
                               rtol=1e-10)


@pytest.mark.parametrize("strategy", ["chief_ray", "centroid_sphere",
                                      "best_fit_sphere"])
def test_wavefront_data_matches_jax(singlet, strategy):
    _, _, (jm, jp), (tm, tp) = singlet
    px, py = jgd("hexapolar", RINGS)
    dj = jwf.wavefront_data(jm, jp, SINGLET_FIELD, 0.55, px, py,
                            strategy=strategy, engine="xla")
    tpx, tpy = tgd("hexapolar", RINGS, device="cpu")
    dt = twf.wavefront_data(tm, tp, SINGLET_FIELD, 0.55, tpx, tpy,
                            strategy=strategy)
    _hold_wavefront(dt, dj)


def test_wavefront_grid_matches_jax(singlet):
    """Two fields x two wavelengths: every leaf [F, W, ...], each pair the
    JAX package's wavefront, and the tilt removal of one pair."""
    _, _, (jm, jp), (tm, tp) = singlet
    fields, wls = [(0.0, 0.0), SINGLET_FIELD], [0.48, 0.65]
    px, py = jgd("hexapolar", RINGS)
    tpx, tpy = tgd("hexapolar", RINGS, device="cpu")
    grid = twf.wavefront_grid(tm, tp, fields, wls, tpx, tpy)
    assert grid.opd.shape == (2, 2, tpx.shape[0])
    assert grid.radius.shape[:2] == (2, 2) and len(grid.center) == 3
    for i, f in enumerate(fields):
        for j, wl in enumerate(wls):
            dj = jwf.wavefront_data(jm, jp, f, wl, px, py, engine="xla")
            one = twf.WavefrontData(
                grid.pupil_x[i, j], grid.pupil_y[i, j], grid.pupil_z[i, j],
                grid.opd[i, j], grid.intensity[i, j], grid.radius[i, j])
            _hold_wavefront(one, dj)
    np.testing.assert_allclose(_np(twf.fit_and_remove_tilt(one)),
                               np.asarray(jwf.fit_and_remove_tilt(dj)),
                               rtol=0, atol=1e-7)


@pytest.fixture
def jax_pairwise_grid(monkeypatch):
    """The JAX facade takes its grid pair by pair (the JAX package's own
    strategy on an accelerator, wavefront.py:336-340, identical to its
    vmapped grid), so that its eager operations share the ones this file
    has compiled already instead of compiling a vmapped program."""
    def pairwise(model, params, fields, wavelengths, Px, Py, strategy):
        data = [jwf.wavefront_data(model, params, f, wl, Px, Py,
                                   strategy=strategy, engine="xla")
                for f in fields for wl in wavelengths]
        return jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs).reshape(
                (len(fields), len(wavelengths)) + jnp.shape(xs[0])), *data)
    monkeypatch.setattr(jwf, "wavefront_grid", pairwise)


def test_opd_and_zernike_opd_match_jax(singlet, jax_pairwise_grid):
    jb, tb = singlet[0], singlet[1]
    jz = jwf.ZernikeOPD(jb(), SINGLET_FIELD, 0.55, num_rings=RINGS,
                        num_terms=15)
    tz = ZernikeOPD(tb(), SINGLET_FIELD, 0.55, num_rings=RINGS, num_terms=15,
                    device="cpu")
    np.testing.assert_allclose(_np(tz.coeffs), np.asarray(jz.coeffs),
                               rtol=0, atol=1e-7)
    for q in ("rms", "peak_to_valley"):
        np.testing.assert_allclose(float(getattr(tz.opd, q)()),
                                   float(getattr(jz.opd, q)()), rtol=1e-9,
                                   err_msg=q)
    # the fan: the cross distribution's two lines
    fan = OPDFan(tb(), fields=[SINGLET_FIELD], wavelengths=[0.55],
                 num_rays=9, device="cpu")
    d = fan.get_data(SINGLET_FIELD, 0.55)
    px, py = jgd("cross", 9)
    dj = jwf.wavefront_data(singlet[2][0], singlet[2][1], SINGLET_FIELD, 0.55,
                            px, py, engine="xla")
    np.testing.assert_allclose(_np(d.opd), np.asarray(dj.opd), rtol=0,
                               atol=1e-7)
    assert fan.pupil_coord.shape == (9,)


def test_fft_psf_and_mtf_match_jax(singlet):
    """One FFTMTF in each package (its FFTPSF inside): the PSF, the Strehl
    ratio, both MTF curves, the frequency axis and the cutoff."""
    jb, tb = singlet[0], singlet[1]
    jm_ = jmtf.FFTMTF(jb(), SINGLET_FIELD, num_rays=32)
    tm_ = FFTMTF(tb(), SINGLET_FIELD, num_rays=32, device="cpu")
    jps, tps = jm_.psf_obj, tm_.psf_obj
    assert (tps.num_rays, tps.grid_size) == (jps.num_rays, jps.grid_size)
    np.testing.assert_allclose(_np(tps.psf), np.asarray(jps.psf), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(float(tps.strehl_ratio()),
                               float(jps.strehl_ratio()), rtol=1e-9)
    for k in ("mtf_tangential", "mtf_sagittal", "freq"):
        np.testing.assert_allclose(_np(getattr(tm_, k)),
                                   np.asarray(getattr(jm_, k)), rtol=1e-9,
                                   atol=1e-8, err_msg=k)
    np.testing.assert_allclose(float(tm_.cutoff), float(jm_.cutoff),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# the wavefront operands, value and gradient
# ---------------------------------------------------------------------------

# one hexapolar bundle for both, so that the JAX references share their
# compiled operations
_OPERANDS = {
    "rms_wavefront_error": dict(Hx=0.0, Hy=0.6, num_rays=RINGS,
                                wavelength=0.55),
    "OPD_difference": dict(Hx=0.0, Hy=0.6, num_rays=RINGS, wavelength=0.55,
                           distribution="hexapolar"),
}


def _with_radii(params, radii, values):
    """A copy of the parameter tree with surface s's radius values[i]."""
    p = dict(params, surfaces=[dict(sp, geom=dict(sp["geom"]))
                               for sp in params["surfaces"]])
    for i, s in enumerate(radii):
        p["surfaces"][s]["geom"]["radius"] = values[i]
    return p


@pytest.mark.parametrize("name", sorted(_OPERANDS))
def test_wavefront_operand_matches_jax(singlet, name):
    """Value and gradient with respect to both radii of the singlet against
    jax.value_and_grad in float64; then the same operand through K1's and
    K2's plain versions in the split mode (float32) against the float64
    eager one."""
    _, tb, (jm, jp), _ = singlet
    kw = _OPERANDS[name]
    radii = [1, 2]
    r0 = [float(jp["surfaces"][s]["geom"]["radius"]) for s in radii]
    vj, gj = jax.value_and_grad(lambda r: jopt.operand_registry[name](
        jm, _with_radii(jp, radii, r), **kw))(jnp.asarray(r0))
    gj = np.asarray(gj)

    def port(dtype):
        m, p = tb().build(device="cpu", dtype=dtype)
        r = torch.tensor(r0, dtype=dtype, requires_grad=True)
        v = topt.operand_registry[name](m, _with_radii(p, radii, r), **kw)
        return v.detach(), torch.autograd.grad(v, r)[0]
    v64, g64 = port(F64)
    assert math.isfinite(float(vj)) and np.all(np.isfinite(gj))
    np.testing.assert_allclose(float(v64), float(vj), rtol=1e-8)
    np.testing.assert_allclose(_np(g64), gj, rtol=1e-6,
                               atol=1e-9 * np.abs(gj).max())
    with engine_override("kernel"):
        v32, g32 = port(F32)
    np.testing.assert_allclose(float(v32), float(v64), rtol=1e-3)
    np.testing.assert_allclose(_np(g32), _np(g64), rtol=2e-2,
                               atol=2e-2 * float(g64.abs().max()))


def test_split_wavefront_routing(cooke):
    """The split path runs for CUDA pupils and under the kernel override,
    never eagerly; tilted stacks and aspheres are refused."""
    tm = cooke[3][0]
    assert tgt.supports_split_opd(tm)
    assert twf._split_wavefront_eligible(tm, "cuda")
    assert not twf._split_wavefront_eligible(tm, "cpu")
    with engine_override("kernel"):
        assert twf._split_wavefront_eligible(tm, "cpu")
    with engine_override("eager"):
        assert not twf._split_wavefront_eligible(tm, "cuda")
    for name in ("TiltedSinglet", "AsphericSinglet"):
        m, p = builders(name)[1]().build(device="cpu")
        assert tgt.supports_model(m) and not tgt.supports_split_opd(m)
        assert not twf._split_wavefront_eligible(m, "cuda")
        with pytest.raises(ValueError):
            tgt.gen_trace_conic(m, p, torch.zeros(4), torch.zeros(4), 0.55,
                                opd_split=True)
        gen, consts, acoef = tgt.gen_tables(m, p, 0.55)
        with pytest.raises(ValueError):
            tgt.gen_trace_plain(gen, consts[None], acoef, torch.zeros(4),
                                torch.zeros(4), tgt.model_flags(m, p), True,
                                "split")


# ---------------------------------------------------------------------------
# K1/K2 sub-slice (g): the plain versions against the interpreted kernels
# ---------------------------------------------------------------------------

def _hold_k1(out, ref, pos_atol):
    names = ("x", "y", "z", "L", "M", "N", "intensity", "opd")
    got = [_np(o).reshape(-1) for o in out]
    exp = [np.asarray(r).reshape(-1) for r in ref]
    assert np.array_equal(np.isfinite(got[0]), np.isfinite(exp[0]))
    for i, k in enumerate(names):
        if k == "intensity":
            np.testing.assert_allclose(got[i], exp[i], rtol=1e-6)
            continue
        rtol, atol = ((1e-4, pos_atol) if k in "xyz" else
                      (0.0, 1e-5) if k in "LMN" else (0.0, 2e-3))
        np.testing.assert_allclose(got[i], exp[i], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def hubble_split_k2():
    """jax.vjp of diff_gen_trace in the split mode (the Pallas K1 and K2 in
    interpret mode) on the benchtop Hubble (two mirrors, the obscuration;
    the JAX gradient suite's scale, at which float32 pupil cotangents are
    not noise), Hy 0.3, 256 samples. Its tables are the port's in the split
    mode (the plain mode's equal the JAX entry's,
    tests/test_torch_widened.py::test_packed_tables_match_jax)."""
    jb, tb = builders("BenchtopHubble")
    jm, jp = jb().build()
    tm, tp = tb().build(device="cpu", dtype=F32)
    gen, consts, acoef = tgt.gen_tables(tm, tp, tp["wavelengths"],
                                        torch.zeros(1), torch.tensor([0.3]))
    consts = tgt.split_consts(tp, gen, consts)
    tables = {k: np.asarray(v) for k, v in
              (("gen", gen), ("consts", consts), ("acoef", acoef))}
    tables["flags"] = jpt.model_flags(jm, jp)
    n = 256
    px, py = _pupil(n, seed=8)
    f = diff_gen_trace(tables["flags"], n // 128, True, True, False, None,
                       True)
    outs, vjp = jax.vjp(f, *(jnp.asarray(tables[k]) for k in
                             ("gen", "consts", "acoef")),
                        jnp.asarray(px).reshape(-1, 128),
                        jnp.asarray(py).reshape(-1, 128))
    cot = np.random.default_rng(13).normal(size=(8, 1, 1, n)).astype(
        np.float32)
    grads = vjp(tuple(jnp.asarray(c.reshape(1, 1, -1, 128)) for c in cot))
    return tables, px, py, cot, outs, grads, jp


def test_plain_k1_split_matches_interpreted_pallas(hubble_split_k2):
    """The split mode through mirrors and the obscuration, by
    gen_trace_conic: surface 1's gap from the launch plane as the JAX entry
    sets it, the base as the JAX entry sums it, z local or global."""
    tables, px, py, _, outs, _, jp = hubble_split_k2
    _, tb = builders("BenchtopHubble")
    tm, tp = tb().build(device="cpu", dtype=F32)
    flags = jax_flags_as_port(tables["flags"])
    assert flags == tgt.model_flags(tm, tp)
    consts = tables["consts"][0]
    jpos = jpositions(jp)
    np.testing.assert_allclose(consts[0, 27], float(jpos[1])
                               - float(tables["gen"][0, 4]), rtol=1e-6)
    rays, base = tgt.gen_trace_conic(tm, tp, torch.tensor(px),
                                     torch.tensor(py), 0.55, 0.0, 0.3,
                                     final_prop=True, opd_split=True,
                                     keep_local_z=True)
    out = torch.stack([getattr(rays, k) for k in (
        "x", "y", "z", "L", "M", "N", "intensity", "opd")])
    _hold_k1(out, outs, pos_atol=2e-4)
    blocked = _np(out[6]) == 0.0
    assert blocked.any() and not blocked.all()
    sigma = np.cumprod([1.0] + [-1.0 if f[1] else 1.0 for f in flags])[:-1]
    np.testing.assert_allclose(float(base),
                               np.sum(sigma * consts[:, 3] * consts[:, 27]),
                               rtol=1e-6)
    glob, _ = tgt.gen_trace_conic(tm, tp, torch.tensor(px), torch.tensor(py),
                                  0.55, 0.0, 0.3, final_prop=True,
                                  opd_split=True)
    np.testing.assert_allclose(_np(glob.z), _np(rays.z) + float(jpos[-1]),
                               rtol=1e-6)


def test_plain_k2_split_matches_interpreted_pallas_k2(hubble_split_k2):
    """dgen, dconsts (columns 0-5 and 27, the vertex gap), dPx and dPy of
    the split mode."""
    tables, px, py, cot, _, grads, _ = hubble_split_k2
    jdgen, jdconsts, jdacoef, jdpx, jdpy = [np.asarray(g) for g in grads]
    t = [torch.tensor(np.asarray(tables[k]))
         for k in ("gen", "consts", "acoef")]
    got = gen_trace_bwd_plain(*t, torch.tensor(px), torch.tensor(py),
                              torch.tensor(cot),
                              jax_flags_as_port(tables["flags"]), True,
                              "split")
    cols = list(range(6)) + [27]
    for label, g, e in (("dgen", got[0], jdgen),
                        ("dconsts", got[1][..., cols], jdconsts[..., cols]),
                        ("dPx", got[3], jdpx.reshape(-1)),
                        ("dPy", got[4], jdpy.reshape(-1))):
        scale = max(float(np.max(np.abs(e))), 1e-30)
        np.testing.assert_allclose(_np(g), e, rtol=3e-3, atol=3e-3 * scale,
                                   err_msg=label)
    assert np.count_nonzero(jdconsts[0, :, 27]) >= 3
    assert not np.any(jdacoef) and not torch.any(got[2])


def test_plain_k1_kahan_matches_interpreted_pallas():
    """The compensated sum on the steep TIR singlet (3 surfaces, lost
    rays), both fields in one call."""
    jb, tb = builders("TIRSinglet")
    jm, jp = jb().build()
    px, py = _pupil(256, seed=9)
    rays = jpt.pallas_gen_trace_conic(
        jm, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jp),
        jnp.asarray(px), jnp.asarray(py), jnp.asarray([0.55], jnp.float32),
        Hx=jnp.zeros(2, jnp.float32), Hy=jnp.asarray([0.0, 1.0], jnp.float32),
        final_prop=True, interpret=True, kahan=True, block_rows=2)
    tm, tp = tb().build(device="cpu", dtype=F32)
    gen, consts, acoef = tgt.gen_tables(tm, tp, tp["wavelengths"],
                                        torch.zeros(2),
                                        torch.tensor([0.0, 1.0]))
    out = tgt.gen_trace_plain(gen, consts, acoef, torch.tensor(px),
                              torch.tensor(py), tgt.model_flags(tm, tp),
                              True, "kahan")
    _hold_k1(out, [getattr(rays, k) for k in ("x", "y", "z", "L", "M", "N",
                                              "intensity", "opd")],
             pos_atol=2e-4)
    assert np.isnan(_np(out[0])).any()


# ---------------------------------------------------------------------------
# the float32 error bounds of the JAX suite, on the port's plain version
# ---------------------------------------------------------------------------

def _f32_against_f64(name, n=4096, seed=2):
    """(f64 eager OPD, plain OPD, Kahan OPD, split deviation, split base)
    of the on-axis bundle, the kernels' plain versions at float32 from the
    float32 parameters. 4096 samples where the JAX suite takes 512: on
    Hubble the Kahan mode's gain over the plain sum is a fraction of a
    percent of the mean error in the port's IEEE arithmetic (no FMA), below
    what 512 samples resolve."""
    tb = builders(name)[1]
    m64, p64 = tb().build(device="cpu")
    m32, p32 = tb().build(device="cpu", dtype=F32)
    px, py = _pupil(n, seed=seed)
    r64 = final_rays(m64, p64, 0.0, 0.0, 0.55, torch.tensor(px, dtype=F64),
                     torch.tensor(py, dtype=F64), engine="eager")
    px, py = torch.tensor(px), torch.tensor(py)
    kw = dict(final_prop=True)
    plain = tgt.gen_trace_conic(m32, p32, px, py, 0.55, **kw)
    kahan = tgt.gen_trace_conic(m32, p32, px, py, 0.55, kahan=True, **kw)
    split, base = tgt.gen_trace_conic(m32, p32, px, py, 0.55, opd_split=True,
                                      **kw)
    return (_np(r64.opd), _np(plain.opd).astype(np.float64),
            _np(kahan.opd).astype(np.float64),
            _np(split.opd).astype(np.float64), float(base))


@pytest.fixture(scope="module")
def f32_errors():
    return {name: _f32_against_f64(name)
            for name in ("HubbleTelescope", "ObjectiveUS008879901")}


def test_kahan_opd_f32_error(f32_errors):
    """The compensated sum is never worse than the plain one and holds the
    JAX suite's bounds (tests/test_pallas_grad.py:323-337)."""
    for name, bound in (("ObjectiveUS008879901", 3e-5),
                        ("HubbleTelescope", 2.5e-3)):
        o64, plain, kahan, _, _ = f32_errors[name]
        ok = np.isfinite(o64) & np.isfinite(plain)
        ep = np.abs(plain - o64)[ok].mean()
        ek = np.abs(kahan - o64)[ok].mean()
        assert ek <= ep * 1.001, (name, ek, ep)
        assert ek < bound, (name, ek)


def test_split_opd_meter_scale(f32_errors):
    """The split deviation holds wave accuracy at meter scale, the Kahan
    mode is >10x worse on Hubble, and base + deviation is the full OPD
    (tests/test_pallas_grad.py:368-420)."""
    wl_mm = 0.55e-3
    errs = {}
    for name in ("HubbleTelescope", "ObjectiveUS008879901"):
        o64, _, kahan, dev, base = f32_errors[name]
        ok = np.isfinite(o64) & np.isfinite(dev) & np.isfinite(kahan)
        d64 = o64[ok] - o64[ok].mean()
        ds = dev[ok] - dev[ok].mean()
        dk = kahan[ok] - kahan[ok].mean()
        errs[name] = (np.max(np.abs(ds - d64)) / wl_mm,
                      np.sqrt(np.mean((ds - d64) ** 2)) / wl_mm,
                      np.max(np.abs(dk - d64)) / wl_mm)
        assert np.max(np.abs(base + dev[ok] - o64[ok])) \
            < 2e-7 * abs(base) + 1e-3
    mx, rms, kah = errs["HubbleTelescope"]
    assert mx < 0.15 and rms < 0.04, (mx, rms)
    assert kah > 10 * mx, (kah, mx)
    assert errs["ObjectiveUS008879901"][0] < 0.02


def test_split_wavefront_meter_scale():
    """Hubble's chief-ray wavefront through the split path (K1's plain
    version at float32) is within 0.06 waves RMS and 0.2 max of the float64
    eager wavefront; the plain float32 path is > 0.5 waves RMS off
    (tests/test_analysis.py:240-279)."""
    _, tb = builders("HubbleTelescope")
    m64, p64 = tb().build(device="cpu")
    m32, p32 = tb().build(device="cpu", dtype=F32)
    px, py = tgd("hexapolar", 8, device="cpu")
    for field in ((0.0, 0.0), (0.0, 1.0)):
        d64 = twf.wavefront_data(m64, p64, field, 0.55, px, py)
        with engine_override("kernel"):
            ds = twf.wavefront_data(m32, p32, field, 0.55, px.float(),
                                    py.float())
        o64, osp = _np(d64.opd), _np(ds.opd).astype(np.float64)
        ok = np.isfinite(o64) & np.isfinite(osp)
        err = np.abs(osp[ok] - o64[ok])
        assert np.sqrt(np.mean(err**2)) < 0.06, (field, err.max())
        assert err.max() < 0.2, (field, err.max())
    d32 = twf.wavefront_data(m32, p32, (0.0, 0.0), 0.55, px.float(),
                             py.float(), engine="eager")
    o64 = _np(twf.wavefront_data(m64, p64, (0.0, 0.0), 0.55, px, py).opd)
    o32 = _np(d32.opd).astype(np.float64)
    ok = np.isfinite(o64) & np.isfinite(o32)
    assert np.sqrt(np.mean((o32[ok] - o64[ok]) ** 2)) > 0.5


def test_objective_sample_matches_jax():
    """The 25-surface objective: flags, the split scope, the float64 eager
    trace of an off-axis bundle and its first-order data (XPL among
    them)."""
    jb, tb = builders("ObjectiveUS008879901")
    jlens = jb()
    jm, jp = jlens.build()
    tm, tp = tb().build(device="cpu")
    tpar = Paraxial(tm, tp)
    for q in ("XPL", "EPL", "EPD", "FNO"):
        np.testing.assert_allclose(float(getattr(tpar, q)()),
                                   float(getattr(jlens.paraxial, q)()),
                                   rtol=1e-10, err_msg=q)
    assert tgt.model_flags(tm, tp) == jax_flags_as_port(
        jpt.model_flags(jm, jp))
    assert tgt.supports_split_opd(tm) and jpt.supports_split_opd(jm)
    px, py = jgd("hexapolar", RINGS)
    rj = j_real.trace(jm, jp, 0.0, 1.0, 0.5876, px, py)
    rt = final_rays(tm, tp, 0.0, 1.0, 0.5876, *tgd("hexapolar", RINGS,
                                                    device="cpu"),
                    engine="eager")
    for k in ("x", "y", "z", "opd"):
        np.testing.assert_allclose(_np(getattr(rt, k)),
                                   np.asarray(getattr(rj, k)), rtol=0,
                                   atol=1e-9, err_msg=k)
